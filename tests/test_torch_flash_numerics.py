"""The arithmetic of the tensor-core flash kernel, rehearsed on the CPU.

csrc/flash.cu's bf16 kernel runs S = Q·Kᵀ on the tensor cores (bf16
products, exact, summed in f32), the online softmax in f32 per 64-key tile
on scores kept in base 2 (s·scale·log2 e, p = 2^(s - m)), and P·V with P
split into two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi), both
accumulated in f32. `emulate` below repeats that arithmetic in plain
torch, query tile by query tile over the key tiles the kernel visits (it
is no part of the package) and is held against `attention_ref` on bf16
inputs under the limits chip_smoke.py holds the kernel to: every error
within 2 bf16 ulps of max(|got|, |want|) plus 1e-4 of the largest |want|,
and bits differing in at most 1% of the outputs. With a single bf16 P the
same emulation breaks the bits limit: that is the reason for the split.

This is a rehearsal of the design, not a guard of the kernel: no package
code runs here, so csrc/flash.cu can drift from `emulate` without a test
here failing. The kernel itself is held against attention_ref, under the
same limits, on the card by chip_smoke.py.

    PYTHONPATH=src python tests/test_torch_flash_numerics.py

prints the bits-differing share of both variants on each case.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.attention.ref import attention_ref


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: PyTorch's intra-op threads, next to the
    other test workers' and JAX's, only oversubscribe the cores, so each
    test runs on one (and puts the count back)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KQ, KB = 64, 64          # query rows a block, keys a tile: csrc/flash.cu
NEG = -1e30              # the kernels' masked score
BF16_ULPS, BF16_FLOOR, BF16_BITS_SHARE = 2, 1e-4, 0.01   # chip_smoke.py

#: (case, Hq, Hkv, Lq, Lk, D, Dv, causal, window, q_offset)
CASES = (
    ("D 128, GQA 8, prompt over a cache", 8, 1, 128, 256, 128, 128, True, 0, 0),
    ("D 80, GQA 4, prompt over a cache", 8, 2, 96, 160, 80, 80, True, 0, 0),
    ("ragged Lq", 8, 1, 37, 300, 128, 128, True, 0, 0),
    ("q_offset", 8, 2, 50, 300, 80, 80, True, 0, 200),
    ("window", 8, 2, 192, 192, 80, 80, True, 64, 0),
    ("Lq = 1, decode", 8, 1, 1, 300, 128, 128, True, 0, 250),
    ("non-causal", 8, 2, 64, 100, 128, 128, False, 0, 0),
    # MLA's naive form (MiniCPM3-4B): q and k of 96, v of 64, no GQA
    ("MLA D 96 Dv 64, prompt over a cache", 8, 8, 128, 256, 96, 64, True, 0, 0),
    ("MLA D 96 Dv 64, decode", 8, 8, 1, 300, 96, 64, True, 0, 250),
)


def emulate(q, k, v, *, causal, window, q_offset, split=True):
    """The bf16 kernel's arithmetic, block by block: per 64-row query tile,
    the 64-key tiles from k_first up to the last key a row of the tile can
    see (the kernel's tile skip), f32 scores from bf16 q and k in base 2,
    the online softmax (masked p exactly 0), P·V with P in two bf16 terms
    (`split`) or one, f32 accumulation, bf16 output (v's head dim)."""
    b, hq, lq, d = q.shape
    dv = v.shape[-1]
    group = hq // k.shape[1]
    lk = k.shape[2]
    scale2 = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    kr = k.float().repeat_interleave(group, 1)
    vr = v.float().repeat_interleave(group, 1)
    out = torch.empty((b, hq, lq, dv), dtype=torch.bfloat16)
    for q0 in range(0, lq, KQ):
        qt = q[:, :, q0:q0 + KQ].float()
        rows = qt.shape[2]
        qpos = torch.arange(q0, q0 + rows)[:, None] + q_offset
        k_lo, k_hi = 0, lk
        if causal:
            k_hi = min(lk, q_offset + q0 + rows)
        if window > 0:
            k_lo = max(0, q_offset + q0 - window + 1)
        m = torch.full((b, hq, rows, 1), NEG)
        l = torch.zeros((b, hq, rows, 1))
        acc = torch.zeros((b, hq, rows, dv))
        for k0 in range(k_lo // KB * KB, k_hi, KB):
            kt, vt = kr[:, :, k0:k0 + KB], vr[:, :, k0:k0 + KB]
            kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
            ok = torch.ones((rows, kt.shape[2]), dtype=torch.bool)
            if causal:
                ok &= kpos <= qpos
            if window > 0:
                ok &= kpos > qpos - window
            s = torch.where(ok, (qt @ kt.transpose(-1, -2)) * scale2,
                            torch.tensor(NEG))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.where(ok, torch.exp2(s - m_new), torch.tensor(0.0))
            l = l * alpha + p.sum(-1, keepdim=True)
            p_hi = p.bfloat16().float()
            pv = p_hi @ vt
            if split:
                pv = pv + (p - p_hi).bfloat16().float() @ vt
            acc = acc * alpha + pv
            m = m_new
        out[:, :, q0:q0 + rows] = (acc / l.clamp_min(1e-20)).bfloat16()
    return out


def inputs(case, seed):
    _, hq, hkv, lq, lk, d, dv, *_ = case
    rng = np.random.default_rng(seed)
    mk = lambda h, n, w: torch.from_numpy(
        rng.standard_normal((1, h, n, w), np.float32)).bfloat16()
    return mk(hq, lq, d), mk(hkv, lk, d), mk(hkv, lk, dv)


def against_ref(case, seed, split):
    """(bits-differing share, worst error over the ulp limit) of the
    emulation against attention_ref."""
    *_, causal, window, q_offset = case
    q, k, v = inputs(case, seed)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = emulate(q, k, v, split=split, **kw)
    want = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2, atol=5e-2)
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    limit = BF16_ULPS * ulp + BF16_FLOOR * float(w.abs().max())
    bits = float((got.view(torch.int16) != want.view(torch.int16)).float().mean())
    return bits, float(((g - w).abs() / limit).max())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_p_meets_the_bf16_limits(case):
    bits, over = against_ref(case, 0, split=True)
    assert bits <= BF16_BITS_SHARE and over <= 1, (bits, over)


def test_single_bf16_p_breaks_the_bits_limit():
    """The measured reason for the split, on the first case."""
    bits, _ = against_ref(CASES[0], 0, split=False)
    assert bits > BF16_BITS_SHARE, bits


if __name__ == "__main__":
    for case in CASES:
        split = against_ref(case, 0, split=True)
        single = against_ref(case, 0, split=False)
        print(f"{case[0]:36s} bits differ: split P {split[0]:.4%} "
              f"(ulp limit x{split[1]:.3f}), single bf16 P {single[0]:.4%} "
              f"(x{single[1]:.3f})")
