"""The stateless synthetic data pipeline of the training path."""
