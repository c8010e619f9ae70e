"""End-to-end training example on the PyTorch/CUDA port (the twin of
``examples/train_lm.py``): a reduced qwen3-family model for 200 steps with
checkpoint/restart and an injected failure at step 57. Runs on the card, as
``train.main`` does; its checkpoints go to a directory of its own (a run
resumes from any committed checkpoint there).

  PYTHONPATH=src python examples/train_lm_torch.py
"""
import os
import tempfile

from repro_torch.launch.train import main

#: the JAX example's command line, with a checkpoint directory of its own
ARGV = ["--arch", "qwen3-1.7b", "--reduced",
        "--steps", "200", "--batch", "8", "--seq", "128",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                   "repro_torch_example_train"),
        "--fail-at", "57", "--lr", "3e-3"]

if __name__ == "__main__":
    main(ARGV)
