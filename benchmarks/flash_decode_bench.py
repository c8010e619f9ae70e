#!/usr/bin/env python3
"""Device time of ``ops.flash_decode`` at serving shapes, beside its bound,
its plain version and SDPA, on one CUDA device.

    python3 benchmarks/flash_decode_bench.py [--shape B SMAX ...] [--reps N]

Each row is ``chip_smoke.py``'s ``lm_time_decode`` (bf16, H = 16, KV = 8,
hd = 128, kv_len = Smax) from the ``chip_smoke.py`` of the tree the script
lies in. Its signature is the same in earlier trees, whose kernel took
kv_len as a Python int, so the script also times an earlier tree's kernel:
copy it into that tree's ``benchmarks/`` and run it there. One JSON line a
shape, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

# chip_smoke exits on import where there is no CUDA device
from chip_smoke import LM_SEED, card_line, lm_time_decode  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", nargs=2, type=int, action="append",
                    metavar=("B", "SMAX"))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED + 1)
    card = card_line()
    for B, Smax in args.shape or [(24, 24), (24, 2048), (1, 32768)]:
        print(json.dumps({**lm_time_decode(gen, B, Smax, Smax, args.reps),
                          "card": card}), flush=True)
    print(card)


if __name__ == "__main__":
    main()
