"""The port's language-model kernels against the JAX package, on the CPU.

On a CPU tensor each wrapper of ``repro_torch.kernels.ops`` runs its plain
version (the CUDA kernels themselves run in ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` on the card). Each is held against two things: the JAX
package's Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs
it, and the matching function of ``repro.kernels.ref``. Shapes, block sizes
and tolerances are those of ``tests/test_kernels.py`` (attention 2e-5 in
float32 and 2e-2 in bfloat16, RMSNorm 1e-6 in float32 and 2e-2 in bfloat16,
as ``assert_allclose``'s atol = rtol), plus the cases the serving path adds.

Inputs are made with numpy from a seed; a bfloat16 input is cast from the
same float32 array in both frameworks, and the test checks that both hold
identical bits.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.kernels.rmsnorm import rms_norm as pallas_rms_norm
from repro.models import attention as jattn
from repro_torch.kernels import _lm, ops, rmsnorm
from repro_torch.kernels import decode_attention as fd
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
RMS_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
AGAINST = ("pallas_interpret", "jax_ref")


def _pair(a: np.ndarray, dtype: str):
    """The same values in JAX and in torch: cast from one float32 array in
    both frameworks, with identical bits."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(a, jnp.float32).astype(jdt)
    t = torch.from_numpy(np.array(a, np.float32)).to(tdt)
    if dtype == "bfloat16":
        bits = torch.from_numpy(np.asarray(j).view(np.int16).copy())
        assert torch.equal(t.view(torch.int16), bits)
    return j, t


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# tests/test_kernels.py::test_flash_attention_vs_ref
FA_CASES = [
    (2, 128, 4, 2, 64, "float32", True, 0),
    (1, 256, 4, 4, 32, "float32", True, 64),
    (2, 100, 2, 1, 16, "float32", True, 0),     # non-divisible seq (padding)
    (1, 64, 8, 2, 128, "float32", False, 0),
    (2, 128, 4, 2, 64, "bfloat16", True, 0),
    (1, 192, 6, 3, 32, "bfloat16", True, 32),
    # head dim 96 (phi3-mini-3.8b at full width)
    (1, 130, 4, 4, 96, "float32", True, 0),
    (2, 100, 4, 2, 96, "bfloat16", True, 32),
]


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("B,Sq,H,KV,hd,dtype,causal,win", FA_CASES)
def test_flash_attention_vs_jax(B, Sq, H, KV, hd, dtype, causal, win,
                                against):
    rng = np.random.default_rng(Sq + H)
    q, tq = _pair(rng.standard_normal((B, Sq, H, hd)), dtype)
    k, tk = _pair(rng.standard_normal((B, Sq, KV, hd)), dtype)
    v, tv = _pair(rng.standard_normal((B, Sq, KV, hd)), dtype)
    n = ops.flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=win)
    assert ops.flash_attention.launches == n      # the CPU runs no kernel
    assert got.dtype == tq.dtype and got.shape == tq.shape
    if against == "pallas_interpret":
        want = pallas_attention(q, k, v, causal=causal, window=win,
                                block_q=64, block_kv=64, interpret=True)
    else:
        want = jref.flash_attention_ref(q, k, v, causal=causal, window=win)
    _close(got, want, ATTN_TOL[dtype])


# tests/test_kernels.py::test_flash_decode_vs_ref
DEC_CASES = [
    (2, 256, 200, 4, 2, 64, 0, "float32"),
    (1, 512, 512, 8, 8, 32, 0, "float32"),
    (2, 256, 100, 4, 1, 64, 64, "float32"),     # sliding window
    (1, 384, 300, 4, 2, 128, 0, "bfloat16"),
    # head dim 96 (phi3-mini-3.8b at full width: G = 1)
    (2, 256, 200, 8, 8, 96, 0, "float32"),
    (1, 384, 300, 4, 4, 96, 40, "bfloat16"),
]


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("B,Smax,kv_len,H,KV,hd,win,dtype", DEC_CASES)
def test_flash_decode_vs_jax(B, Smax, kv_len, H, KV, hd, win, dtype,
                             against):
    rng = np.random.default_rng(Smax + kv_len)
    q, tq = _pair(rng.standard_normal((B, 1, H, hd)), dtype)
    kc, tkc = _pair(rng.standard_normal((B, Smax, KV, hd)), dtype)
    vc, tvc = _pair(rng.standard_normal((B, Smax, KV, hd)), dtype)
    n = ops.flash_decode.launches
    got = ops.flash_decode(tq, tkc, tvc, kv_len, window=win)
    assert ops.flash_decode.launches == n
    assert got.dtype == tq.dtype and got.shape == tq.shape
    if against == "pallas_interpret":
        want = pallas_decode(q, kc, vc, kv_len, window=win, block_kv=128,
                             interpret=True)
    else:
        want = jref.decode_attention_ref(q, kc, vc, kv_len, window=win)
    _close(got, want, ATTN_TOL[dtype])


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("B,Smax,kv_len,H,KV,hd,win,dtype", DEC_CASES)
def test_flash_decode_device_kv_len_vs_jax(B, Smax, kv_len, H, KV, hd, win,
                                           dtype, against):
    """kv_len as an int32 tensor of one element (0-d and (1,)), as the
    Pallas kernel takes it: the same bits as the int call, and the Pallas
    kernel given ``jnp.int32(kv_len)`` (or the JAX reference)."""
    rng = np.random.default_rng(Smax + kv_len)
    q, tq = _pair(rng.standard_normal((B, 1, H, hd)), dtype)
    kc, tkc = _pair(rng.standard_normal((B, Smax, KV, hd)), dtype)
    vc, tvc = _pair(rng.standard_normal((B, Smax, KV, hd)), dtype)
    want_int = ops.flash_decode(tq, tkc, tvc, kv_len, window=win)
    for t in (torch.tensor(kv_len, dtype=torch.int32),
              torch.tensor([kv_len], dtype=torch.int32)):
        got = ops.flash_decode(tq, tkc, tvc, t, window=win)
        assert torch.equal(got, want_int)
    if against == "pallas_interpret":
        want = pallas_decode(q, kc, vc, jnp.int32(kv_len), window=win,
                             block_kv=128, interpret=True)
    else:
        want = jref.decode_attention_ref(q, kc, vc, jnp.int32(kv_len),
                                         window=win)
    _close(got, want, ATTN_TOL[dtype])


def test_flash_decode_refuses_a_kv_len_tensor_it_cannot_take():
    qd, kc = torch.zeros((1, 1, 4, 16)), torch.zeros((1, 8, 2, 16))
    with pytest.raises(TypeError, match="int32"):
        ops.flash_decode(qd, kc, kc, torch.tensor(3))            # int64
    with pytest.raises(ValueError, match="one element"):
        ops.flash_decode(qd, kc, kc, torch.tensor([3, 4], dtype=torch.int32))
    with pytest.raises(ValueError, match="one element"):
        ops.flash_decode(qd, kc, kc, torch.ones(1, dtype=torch.int32,
                                                device="meta"))


# ---------------------------------------------------------------------------
# The split-K arithmetic of csrc/decode_attention.cu emulated in torch: each
# split's partial (m, l, acc) over its rows, merged in split order, held
# against the Pallas kernel in interpret mode at the kernel tolerances.
# ---------------------------------------------------------------------------

def _split_k_emulation(q, k_cache, v_cache, kv_len, window, n_split, rows):
    """What the split path computes: split s takes rows [s*rows, (s+1)*rows)
    of the valid range [max(0, kv_len - window), kv_len); float32 scores of
    q * hd**-0.5; its partial is m = max score, l = sum exp(s - m), acc =
    sum exp(s - m) v, or the neutral (-1e30, 0, 0) where it holds no valid
    row; the merge takes M = max m_s, weights exp(m_s - M), in split order,
    and divides by max(l, 1e-30)."""
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = (q.float()[:, 0] * hd ** -0.5).reshape(B, KV, G, hd)
    lo = max(0, kv_len - window) if window > 0 else 0
    parts = []
    for s in range(n_split):
        a, b = max(lo, s * rows), min(kv_len, (s + 1) * rows, Smax)
        if a >= b:
            parts.append((torch.full((B, KV, G), _lm.NEG_INF),
                          torch.zeros((B, KV, G)),
                          torch.zeros((B, KV, G, hd))))
            continue
        sc = torch.einsum("bkgd,bskd->bkgs", qg, k_cache[:, a:b].float())
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        parts.append((m, p.sum(-1), torch.einsum(
            "bkgs,bskd->bkgd", p, v_cache[:, a:b].float())))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    ll, acc = torch.zeros_like(M), torch.zeros((B, KV, G, hd))
    for m, l_s, acc_s in parts:
        w = torch.exp(m - M)
        ll = ll + l_s * w
        acc = acc + acc_s * w[..., None]
    out = acc / ll.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


# B, Smax, kv_len, H, KV, hd, window, dtype: DEC_CASES' shapes, and windows
# that leave most splits empty
SPLIT_CASES = DEC_CASES + [(1, 384, 300, 4, 2, 128, 40, "bfloat16"),
                           (2, 256, 250, 4, 4, 32, 20, "float32")]


@pytest.mark.parametrize("n_split", [1, 3, 7])
@pytest.mark.parametrize("B,Smax,kv_len,H,KV,hd,win,dtype", SPLIT_CASES)
def test_split_k_arithmetic_vs_pallas(B, Smax, kv_len, H, KV, hd, win, dtype,
                                      n_split):
    rng = np.random.default_rng(Smax + kv_len + win)
    q, tq = _pair(rng.standard_normal((B, 1, H, hd)), dtype)
    kc, tkc = _pair(rng.standard_normal((B, Smax, KV, hd)), dtype)
    vc, tvc = _pair(rng.standard_normal((B, Smax, KV, hd)), dtype)
    rows = -(-Smax // n_split)
    got = _split_k_emulation(tq, tkc, tvc, kv_len, win, n_split, rows)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = pallas_decode(q, kc, vc, jnp.int32(kv_len), window=win,
                         block_kv=128, interpret=True)
    _close(got, want, ATTN_TOL[dtype])


def _cuda_constant(name: str) -> int:
    src = _csrc_text("decode_attention.cu")
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_split_rule_constants_match_the_kernel():
    for name in ("MAX_SPLITS", "MAX_HEADS_PER_BLOCK"):
        assert getattr(fd, name) == _cuda_constant(name)
    src = _csrc_text("decode_attention.cu")
    assert "return G <= 2 ? G : MAX_HEADS_PER_BLOCK;" in src
    assert [fd.heads_per_block(g) for g in (1, 2, 3, 4, 8)] == [1, 2, 4, 4, 4]


@pytest.mark.parametrize("sm_count", [1, 114, 132])
@pytest.mark.parametrize("B,H,KV", [(1, 16, 8), (24, 16, 8), (3, 8, 1),
                                    (1, 4, 4), (65535, 2, 1)])
def test_split_rule(B, H, KV, sm_count):
    """The splits cover the cache, none is empty, the count stays within the
    kernel's limit and needs no kv_len; a cache too short to split (the
    serving path's 24 rows) runs as one split."""
    for Smax in (1, 24, 511, 512, 2048, 8192, 32768, 10**6):
        n, rows = fd.num_splits(B, H, KV, Smax, sm_count)
        assert 1 <= n <= fd.MAX_SPLITS and rows >= 1
        assert n * rows >= Smax > (n - 1) * rows
        if Smax < 2 * fd.SPLIT_MIN_ROWS:
            assert n == 1
        if n > 1:
            assert rows >= fd.SPLIT_MIN_ROWS - 1


def test_split_rule_at_the_serving_shapes():
    # qwen3-1.7b (16 query heads, 8 KV heads) on 132 SMs
    assert fd.num_splits(24, 16, 8, 24, 132) == (1, 24)
    assert fd.num_splits(24, 16, 8, 2048, 132) == (3, 683)
    assert fd.num_splits(1, 16, 8, 32768, 132) == (66, 497)


def test_counts_move_by_a_delta():
    """What a CUDA-graph runner does with the counts: take a capture's
    launches back out, and add them once a replay."""
    before = (ops.launch_counts(), ops.variant_counts())
    ops.flash_decode.launches += 2
    ops.flash_decode.launches_by_variant["split"] += 2
    ops.rms_norm.launches += 5
    ops.rms_norm.launches_by_variant["generic"] += 5
    delta = ops.counts_since(before)
    assert delta[0] == {"rms_norm": 5, "flash_attention": 0,
                        "flash_decode": 2}
    assert delta[1]["flash_decode"] == {"single": 0, "split": 2}
    ops.add_counts(delta, times=-1)
    assert (ops.launch_counts(), ops.variant_counts()) == before
    ops.add_counts(delta, times=3)
    assert ops.counts_since(before)[0]["rms_norm"] == 15
    ops.add_counts(delta, times=-3)
    assert (ops.launch_counts(), ops.variant_counts()) == before


# tests/test_kernels.py::test_rmsnorm_vs_ref
RMS_CASES = [
    (64, 256, "float32"), (100, 512, "float32"),   # padding path
    (128, 1024, "bfloat16"), (1, 128, "float32"),
]


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("R,D,dtype", RMS_CASES)
def test_rms_norm_vs_jax(R, D, dtype, against):
    rng = np.random.default_rng(R + D)
    x, tx = _pair(rng.standard_normal((R, D)) * 3, dtype)
    s, ts = _pair(rng.standard_normal((D,)), dtype)
    n = ops.rms_norm.launches
    got = ops.rms_norm(tx, ts)
    assert ops.rms_norm.launches == n
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if against == "pallas_interpret":
        want = pallas_rms_norm(x, s, block_rows=32, interpret=True)
    else:
        want = jref.rms_norm_ref(x, s)
    _close(got, want, RMS_TOL[dtype])


# ---------------------------------------------------------------------------
# What the serving path adds: a q_offset, a window at head_dim 128, a float32
# query against a bfloat16 cache, a cache with one valid row.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,win,q_offset", [(50, 80, 0, 30),
                                                 (33, 33, 7, 0)])
def test_flash_attention_offset_and_window_vs_pallas(Sq, Skv, win, q_offset,
                                                     dtype):
    B, H, KV, hd = 2, 4, 2, 128
    rng = np.random.default_rng(Sq + Skv + win)
    q, tq = _pair(rng.standard_normal((B, Sq, H, hd)), dtype)
    k, tk = _pair(rng.standard_normal((B, Skv, KV, hd)), dtype)
    v, tv = _pair(rng.standard_normal((B, Skv, KV, hd)), dtype)
    got = ops.flash_attention(tq, tk, tv, window=win, q_offset=q_offset)
    want = pallas_attention(q, k, v, window=win, q_offset=q_offset,
                            block_q=64, block_kv=64, interpret=True)
    _close(got, want, ATTN_TOL[dtype])
    # and the full-materialization version of the JAX package's models
    _close(got, jattn.ref_attention(q, k, v, window=win, q_offset=q_offset),
           ATTN_TOL[dtype])


@pytest.mark.parametrize("kv_len,win", [(1, 0), (17, 0), (24, 5)])
def test_flash_decode_float32_query_against_bf16_cache(kv_len, win):
    """The prefill default keeps a bf16 cache beside float32 activations:
    q is not cast to the cache's type, the result is float32."""
    B, Smax, H, KV, hd = 3, 24, 16, 8, 128
    rng = np.random.default_rng(kv_len)
    q, tq = _pair(rng.standard_normal((B, 1, H, hd)), "float32")
    kc, tkc = _pair(rng.standard_normal((B, Smax, KV, hd)), "bfloat16")
    vc, tvc = _pair(rng.standard_normal((B, Smax, KV, hd)), "bfloat16")
    got = ops.flash_decode(tq, tkc, tvc, kv_len, window=win)
    assert got.dtype == torch.float32
    _close(got, jattn.decode_attention(q, kc, vc, kv_len, window=win),
           ATTN_TOL["float32"])


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((4, 8))
    with pytest.raises(TypeError):
        ops.rms_norm(x.half(), torch.ones(8).half())
    with pytest.raises(TypeError):
        ops.rms_norm(x, torch.ones(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ops.rms_norm(x, torch.ones(4))
    q, k = torch.zeros((1, 4, 4, 16)), torch.zeros((1, 4, 3, 16))
    with pytest.raises(ValueError):                   # H % KV != 0
        ops.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, q_offset=-1)
    qd, kc = torch.zeros((1, 1, 4, 16)), torch.zeros((1, 8, 2, 16))
    for bad in (0, 9, 2.0):
        with pytest.raises(ValueError):
            ops.flash_decode(qd, kc, kc, bad)
    with pytest.raises(TypeError):
        ops.flash_decode(qd, kc, kc.bfloat16(), 4)


# ---------------------------------------------------------------------------
# The tensor-core attention kernel's arithmetic (csrc/flash_attention_tc.cu)
# emulated in torch, held against the Pallas kernel in interpret mode at the
# bf16 tolerance: its rounding points differ from the plain version's.
# ---------------------------------------------------------------------------

def _csrc_text(name: str) -> str:
    return (Path(fa.__file__).with_name("csrc") / name).read_text()


def _tc_tiles() -> tuple:
    """The tensor-core kernel's tiles (q rows a work item, kv rows a step),
    read from its source, so that the emulation follows the kernel."""
    src = _csrc_text("flash_attention_tc.cu")
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
                 for n in ("BQ", "BK"))


def _tc_kernel_emulation(q, k, v, *, causal, window, q_offset):
    """What the bf16 tensor-core kernel computes, step by step: per q tile of
    ``BQ`` rows, the kv tiles of ``BK`` rows it visits
    (wholly masked ones skipped, the ragged edge zero-filled); scores as a
    bf16 x bf16 product summed in float32, then scaled in float32 by
    hd ** -0.5 * log2(e); masked to -1e30; an online softmax in base 2 with
    float32 row maxima and sums (of the unrounded p); P rounded to bf16
    before P·V; out = acc / max(l, 1e-30) rounded to bf16."""
    BQ, BK = _tc_tiles()
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale_log2 = (torch.tensor(hd ** -0.5, dtype=torch.float32)
                  * torch.tensor(math.log2(math.e), dtype=torch.float32))
    pad = (-Skv) % BK
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kf, vf = (t.repeat_interleave(G, dim=2) for t in (kf, vf))
    out = torch.empty(q.shape, dtype=torch.float32)
    for q0 in range(0, Sq, BQ):
        qt = q[:, q0:q0 + BQ].float()
        qpos = q_offset + torch.arange(q0, q0 + qt.shape[1])[:, None]
        kv_lo, kv_hi = 0, Skv
        if causal:
            kv_hi = min(Skv, q_offset + q0 + BQ)
            if window > 0:
                kv_lo = max(0, q_offset + q0 - window + 1)
        kv_lo = kv_lo // BK * BK
        m = torch.full((B, H, qt.shape[1]), _lm.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, qt.shape[1], hd))
        for j0 in range(kv_lo, kv_hi, BK):
            s = torch.einsum("bqhd,bkhd->bhqk", qt, kf[:, j0:j0 + BK])
            s = s * scale_log2
            kpos = torch.arange(j0, j0 + BK)[None, :]
            keep = kpos < Skv
            if causal:
                keep = keep & (kpos <= qpos)
            if window > 0:
                keep = keep & (kpos > qpos - window)
            s = torch.where(keep, s, _lm.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.bfloat16().float(), vf[:, j0:j0 + BK])
            m = m_new
        out[:, q0:q0 + BQ] = (acc / l.clamp_min(1e-30)[..., None]
                              ).permute(0, 2, 1, 3)
    return out.to(q.dtype)


# tests/test_kernels.py's shapes (all in bf16, the kernel's only type), and
# the serving path's q_offset and window at head_dim 128
TC_CASES = [(B, Sq, Sq, H, KV, hd, causal, win, 0)
            for B, Sq, H, KV, hd, _dt, causal, win in FA_CASES]
TC_CASES += [(2, 50, 80, 4, 2, 128, True, 0, 30),
             (2, 33, 33, 4, 2, 128, True, 7, 0),
             (1, 300, 300, 4, 1, 64, True, 100, 0),
             (1, 300, 300, 4, 4, 96, True, 0, 0),
             (2, 50, 80, 4, 2, 96, True, 7, 30)]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,win,q_offset", TC_CASES)
def test_tensor_core_arithmetic_vs_pallas(B, Sq, Skv, H, KV, hd, causal, win,
                                          q_offset):
    rng = np.random.default_rng(Sq + Skv + H)
    q, tq = _pair(rng.standard_normal((B, Sq, H, hd)), "bfloat16")
    k, tk = _pair(rng.standard_normal((B, Skv, KV, hd)), "bfloat16")
    v, tv = _pair(rng.standard_normal((B, Skv, KV, hd)), "bfloat16")
    got = _tc_kernel_emulation(tq, tk, tv, causal=causal, window=win,
                               q_offset=q_offset)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    want = pallas_attention(q, k, v, causal=causal, window=win,
                            q_offset=q_offset, block_q=64, block_kv=64,
                            interpret=True)
    _close(got, want, ATTN_TOL["bfloat16"])


# ---------------------------------------------------------------------------
# The RMSNorm wrapper counts a launch as ``row_in_registers`` for the widths
# of REG_WIDTHS; the launcher must dispatch exactly those to that kernel.
# ---------------------------------------------------------------------------

def _rms_register_cases() -> list:
    src = _csrc_text("rmsnorm.cu")
    body = src[src.index("int with_width("):]
    body = body[:body.index("default:")]
    return [int(d) for d in re.findall(r"case (\d+):", body)]


@pytest.mark.parametrize("D", rmsnorm.REG_WIDTHS)
def test_rms_norm_register_widths_match_the_launcher(D):
    src = _csrc_text("rmsnorm.cu")
    assert f"case {D}: return f(std::integral_constant<int, {D}>{{}});" in src
    assert sorted(_rms_register_cases()) == sorted(rmsnorm.REG_WIDTHS)


# ---------------------------------------------------------------------------
# The gradient of a launch: _lm.KernelWithPlainBackward. Its forward is the
# kernel, which needs the card; here the plain version stands in for the
# launch, so the backward's bookkeeping (which inputs, which closures) is
# held to torch.autograd of the plain version, exactly.
# ---------------------------------------------------------------------------

def _plain_backward_cases():
    rng = np.random.default_rng(21)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    kv = torch.tensor([5], dtype=torch.int32)
    return {
        "rms_norm": ((t(6, 32), t(32)),
                     lambda x, s: rmsnorm.rms_norm_ref(x, s, 1e-6)),
        "flash_attention": ((t(2, 9, 4, 16), t(2, 9, 2, 16), t(2, 9, 2, 16)),
                            lambda q, k, v: fa.flash_attention_ref(
                                q, k, v, window=4)),
        "flash_decode": ((t(2, 1, 4, 16), t(2, 7, 2, 16), t(2, 7, 2, 16)),
                         lambda q, k, v: fd.decode_attention_ref(q, k, v,
                                                                 kv)),
    }


@pytest.mark.parametrize("kernel", ["rms_norm", "flash_attention",
                                    "flash_decode"])
@pytest.mark.parametrize("which", ["all", "first"])
def test_plain_backward_equals_the_plain_versions_gradient(kernel, which):
    inputs, plain = _plain_backward_cases()[kernel]
    seen = []

    def launch(*ts):
        seen.append(torch.is_grad_enabled())
        return plain(*ts)

    def grads(fn):
        leaves = [x.clone().requires_grad_(which == "all" or i == 0)
                  for i, x in enumerate(inputs)]
        out = fn(*leaves)
        (out.square() * torch.linspace(-1, 1, out.numel()).reshape(
            out.shape)).sum().backward()
        return out, [x.grad for x in leaves]

    out, got = grads(lambda *ts: _lm.KernelWithPlainBackward.apply(
        launch, plain, *ts))
    want_out, want = grads(plain)
    assert seen == [False]               # the launch runs outside autograd
    assert torch.equal(out.detach(), want_out.detach())
    for i, (g, w) in enumerate(zip(got, want)):
        if which == "first" and i > 0:
            assert g is None and w is None
        else:
            assert torch.equal(g, w), i


def test_wants_grad_only_when_autograd_records():
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    assert _lm.wants_grad(x, y) and not _lm.wants_grad(y, y)
    with torch.no_grad():
        assert not _lm.wants_grad(x, y)
    with torch.inference_mode():
        assert not _lm.wants_grad(y)
