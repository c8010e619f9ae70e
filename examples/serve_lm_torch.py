"""Serving example on the PyTorch/CUDA port: WS-scheduled batched requests
through prefill + decode (the twin of ``examples/serve_lm.py``).

The stealing policy is chosen by simulating the fleet topology with the
paper's simulator (the ``ws_sim`` kernel, see the planner line in the
output); then ``mixtral-8x7b`` at ``reduced()`` serves the 24 requests, its
MoE layers routing each step's tokens with the work-stealing overflow
rebalance, each decode step after the first a replay of one CUDA graph.
Runs on the card, as ``serve.main`` does.

  PYTHONPATH=src python examples/serve_lm_torch.py
"""
from repro_torch.launch.serve import main

#: the JAX example's command line
ARGV = ["--arch", "mixtral-8x7b", "--requests", "24", "--prompt-len", "16",
        "--max-new", "8", "--pods", "2"]

if __name__ == "__main__":
    main(ARGV)
