"""Step builders and the serving entry point of the language-model path."""
