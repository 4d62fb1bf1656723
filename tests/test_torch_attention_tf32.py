"""The fp32 variants of the flash-attention forward (B1), dq (B2) and dkv
(B3) kernels, which run their products on the TF32 tensor cores split into
three (3xTF32), checked on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there). What can be held here:

- a model of their rounding: every operand x of a product is split into
  hi = tf32(x) (cvt.rna: 10 mantissa bits, to nearest, ties away) and
  lo = x - hi cut to tf32 toward zero, and a product is lo hi + hi lo +
  hi hi with fp32 sums. The forward takes 64-key tiles in two warps that
  alternate (online softmax per tile, l from the unsplit fp32
  probabilities, the two halves merged at the end); dkv takes 32-query
  tiles in two alternating warps and adds their sums at the end; dq takes
  16-key tiles in two alternating warps, each tile's df products summed
  apart and added in fp32, the two warps' sums added at the end. Fed the
  same seeded inputs as the JAX package's Pallas ``_flash_forward`` and
  ``_flash_backward`` (interpret mode, fp32) and ``attention_core``, the
  model stays within ``chip_smoke.py``'s fp32 ``tolerance``, its 1e-4
  logsumexp check and its fp32 ``grad_tolerance``; one TF32 product in
  place of three does not;
- the sources: the fp32 bodies issue the tf32 ``mma.sync`` through the
  3xTF32 helpers (dq's with g and h split once in shared memory), the
  header rounds with ``cvt.rna.tf32.f32``, and the CUDA-core dq is gone;
- the routing on the CPU: fp32 tensors take the plain versions, no launch
  counted.
"""

import importlib.util
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from twingan_tpu.ops import attention as jattention  # noqa: E402

from twingan_tpu_torch.ops import attention, cuda_build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = 64     # keys per warp and tile (forward)
QUERIES = 32  # queries per warp and tile (dkv)
DQ_KEYS = 16  # keys per warp and tile (dq)
SPLIT = 2     # warps sharing one row's tiles, taking alternate ones


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: fp32 rounded to 10 mantissa bits, to nearest, ties
    away from zero (half an ulp added to the magnitude's bits, then cut)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """fp32 cut to 10 mantissa bits toward zero (the low 13 bits cleared)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_cut(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products with fp32 sums, the small ones first."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product: what the split is there to avoid."""
    return tf32_rna(a) @ tf32_rna(b)


def forward_model(f, g, h, mm=mm3):
    """(o, lse) as the fp32 forward kernel rounds them."""
    b, n, _ = f.shape
    parts = []
    for half in range(SPLIT):
        m = torch.full((b, n), -torch.inf)
        l = torch.zeros(b, n)
        acc = torch.zeros(b, n, h.shape[-1])
        for i, k0 in enumerate(range(0, n, KEYS)):
            if i % SPLIT != half:
                continue
            s = mm(f, g[:, k0:k0 + KEYS].transpose(1, 2))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            scale = torch.exp(m - m_new)
            l = l * scale + p.sum(-1)
            acc = acc * scale[..., None] + mm(p, h[:, k0:k0 + KEYS])
            m = m_new
        parts.append((m, l, acc))
    (m0, l0, a0), (m1, l1, a1) = parts
    m = torch.maximum(m0, m1)
    w0, w1 = torch.exp(m0 - m), torch.exp(m1 - m)  # the second half may hold no key
    l = w0 * l0 + w1 * l1
    return (w0[..., None] * a0 + w1[..., None] * a1) / l[..., None], m + torch.log(l)


def dkv_model(f, g, h, do, lse, delta, mm=mm3):
    """(dg, dh) as the fp32 dkv kernel rounds them: P^T and dP^T recomputed
    per 32-query tile, the two warps' sums added at the end."""
    n = f.shape[1]
    dg = [torch.zeros_like(g) for _ in range(SPLIT)]
    dh = [torch.zeros_like(h) for _ in range(SPLIT)]
    for i, q0 in enumerate(range(0, n, QUERIES)):
        q = slice(q0, q0 + QUERIES)
        pt = torch.exp(mm(g, f[:, q].transpose(1, 2)) - lse[:, None, q])
        dst = pt * (mm(h, do[:, q].transpose(1, 2)) - delta[:, None, q])
        dh[i % SPLIT] += mm(pt, do[:, q])
        dg[i % SPLIT] += mm(dst, f[:, q])
    return dg[0] + dg[1], dh[0] + dh[1]


def dq_model(f, g, h, do, lse, delta, mm=mm3):
    """df as the fp32 dq kernel rounds it: P and dP recomputed per 16-key
    tile, each 8-key block's dS g summed apart and added in fp32, the two
    warps' sums added at the end."""
    n = f.shape[1]
    df = [torch.zeros_like(f) for _ in range(SPLIT)]
    for i, k0 in enumerate(range(0, n, DQ_KEYS)):
        k = slice(k0, k0 + DQ_KEYS)
        p = torch.exp(mm(f, g[:, k].transpose(1, 2)) - lse[..., None])
        ds = p * (mm(do, h[:, k].transpose(1, 2)) - delta[..., None])
        for kk in range(0, ds.shape[-1], 8):
            df[i % SPLIT] += mm(ds[..., kk:kk + 8], g[:, k0 + kk:k0 + kk + 8])
    return df[0] + df[1]


def _inputs(b, n, c_bar, c, seed):
    """Seeded numpy draws; f and g at twice unit scale, so that the scores
    (and the exponentials' sensitivity to them) are of a trained layer's
    size."""
    rng = np.random.RandomState(seed)
    return [(2.0 if w == c_bar else 1.0) * rng.randn(b, n, w).astype(np.float32)
            for w in (c_bar, c_bar, c, c)]


def _max_err(a, ref) -> tuple[float, float]:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max()), float(np.abs(ref).max())


def _pallas(f, g, h, do):
    """The Pallas forward and backward (interpret mode, fp32): o, lse, df,
    dg, dh."""
    jf, jg, jh, jdo = map(jnp.asarray, (f, g, h, do))
    o, lse = jattention._flash_forward(jf, jg, jh, 128, 128)
    df, dg, dh = jattention._flash_backward(jf, jg, jh, jdo, lse, jnp.sum(jdo * o, axis=-1),
                                            128, 128)
    return o, lse, df, dg, dh


def _model_errors(smoke, f, g, h, do, refs, mm) -> dict:
    """Each output's error against ``refs`` (o, lse, df, dg, dh) beside its
    chip_smoke.py limit."""
    n = f.shape[1]
    tf, tg, th, tdo = map(torch.from_numpy, (f, g, h, do))
    o, lse = forward_model(tf, tg, th, mm)
    delta = torch.sum(tdo * o, dim=-1)
    df = dq_model(tf, tg, th, tdo, lse, delta, mm)
    dg, dh = dkv_model(tf, tg, th, tdo, lse, delta, mm)
    errs = {}
    for name, out, ref in zip(("o", "lse", "df", "dg", "dh"), (o, lse, df, dg, dh), refs):
        err, ref_max = _max_err(out, ref)
        limit = {"o": smoke.tolerance("float32", ref_max),
                 "lse": 1e-4 * max(1.0, ref_max)}.get(
            name, smoke.grad_tolerance("float32", ref_max, n))
        errs[name] = (err, limit)
    return errs


@pytest.mark.parametrize("b,n,c_bar,c", [(2, 512, 8, 64), (1, 256, 32, 256)])
def test_tf32x3_model_within_chip_tolerance(smoke, b, n, c_bar, c):
    """The 3xTF32 model against the Pallas forward and backward (interpret
    mode, fp32) on the same inputs: o within tolerance("float32"), lse
    within 1e-4 of its magnitude, df, dg and dh within
    grad_tolerance("float32"); and a single TF32 product in its place
    misses the output's limit, and df's."""
    f, g, h, do = _inputs(b, n, c_bar, c, seed=n + c)
    refs = _pallas(f, g, h, do)
    errs = _model_errors(smoke, f, g, h, do, refs, mm3)
    assert all(0 < err <= limit for err, limit in errs.values()), errs
    single = _model_errors(smoke, f, g, h, do, refs, mm1)
    assert single["o"][0] > single["o"][1] and single["df"][0] > single["df"][1], single
    assert max(err / limit for err, limit in single.values()) > 4, single
    # The einsum path agrees with the Pallas kernel it stands beside.
    np.testing.assert_allclose(np.asarray(jattention.attention_core(
        *map(jnp.asarray, (f, g, h)))), np.asarray(refs[0]), rtol=1e-4, atol=1e-5)


def test_tf32x3_model_at_ragged_n(smoke):
    """N 200 (a last forward tile of 8 keys, a last dkv tile of 8 queries,
    a last dq tile of 8 keys; the JAX flash kernels reject it): against
    attention_core and jax.grad of it in fp32."""
    b, n, c_bar, c = 2, 200, 8, 64
    f, g, h, do = _inputs(b, n, c_bar, c, seed=7)
    jf, jg, jh, jdo = map(jnp.asarray, (f, g, h, do))
    ref_o = jattention.attention_core(jf, jg, jh)
    ref_lse = jax.nn.logsumexp(jnp.einsum("bic,bjc->bij", jf, jg), axis=-1)
    ref_df, ref_dg, ref_dh = jax.grad(
        lambda *a: jnp.sum(jattention.attention_core(*a) * jdo), argnums=(0, 1, 2))(jf, jg, jh)
    errs = _model_errors(smoke, f, g, h, do, (ref_o, ref_lse, ref_df, ref_dg, ref_dh), mm3)
    assert all(err <= limit for err, limit in errs.values()), errs


def test_tf32_rounding_helpers():
    """tf32_rna is cvt.rna's rounding: to nearest at 10 mantissa bits, ties
    away from zero; the split keeps x to 2^-21 of its magnitude."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4, 1.0 + 3 * ulp / 4])
    assert tf32_rna(x).tolist() == [1.0, 1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp]
    y = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    hi, lo = split(y)
    assert torch.equal(tf32_cut(hi), hi) and torch.equal(tf32_cut(lo), lo)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21
    assert float(((tf32_rna(y) - y).abs() / y.abs()).max()) > 2.0 ** -13


def _source(name: str) -> str:
    with open(os.path.join(cuda_build.CSRC_DIR, name)) as fh:
        return fh.read()


@pytest.mark.parametrize("name,body,end,products", [
    ("flash_attn_fwd.cu", "flash_attn_fwd_tf32_kernel(", "cudaError_t launch_tf32(", 2),
    ("flash_attn_bwd.cu", "flash_attn_dkv_tf32_kernel(", "cudaError_t launch_dkv_tf32(", 4),
])
def test_fp32_bodies_issue_tf32_mma(name, body, end, products):
    """The fp32 bodies take every product through the 3xTF32 helper (S and
    O; S^T, dP^T, dh and dg), which issues the tf32 mma.sync three times, and
    the C entry points send fp32 to them."""
    src = _source(name)
    text = src[src.index(body):src.index(end)]
    assert text.count("mma1688_tf32x3(") == products
    for op in ("TileCopier<", "cp_async_commit()", "split_frag(", "ex2("):
        assert op in text, op
    assert "mma16816(" not in text and "ldmatrix" not in text
    header = _source("flash_mma.cuh")
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    assert "cvt.rna.tf32.f32" in header
    helper = header[header.index("void mma1688_tf32x3("):]
    assert helper[:helper.index("\n}")].count("mma1688_tf32(") == 3
    assert ("launch_tf32<8>(" in src) if name == "flash_attn_fwd.cu" else (
        "return dkv_tf32(in, dg, dh, batch, n, cbar, c, st, s);" in src)


def test_fp32_dq_body_issues_tf32_mma():
    """The fp32 dq body issues the tf32 mma.sync for its three products (S,
    dP, df), each as lo hi, hi lo and hi hi of operands split in advance: it
    splits each staged tile of g and h once in shared memory (each thread
    its own cp.async copies) and only the A operands per warp; the C entry
    point sends fp32 to it, and the CUDA-core dq is gone."""
    src = _source("flash_attn_bwd.cu")
    text = src[src.index("struct SplitTileCopier"):src.index("cudaError_t launch_dq_tf32(")]
    calls = re.findall(r"mma1688_tf32\([^,]+, ([^,]+)\.(lo|hi), b(h|l)", text)
    assert len(calls) == 9
    assert [(part, b) for _, part, b in calls] == [("lo", "h"), ("hi", "l"), ("hi", "h")] * 3
    for op in ("cp_async16(", "cp_async_commit()", "cp_async_wait<0>()", "split_tile(buf ^ 1)",
               "split_tf32(v.x)",
               "split_frag(ds[0][kk][0], ds[0][kk][2], ds[0][kk][1], ds[0][kk][3])",
               "ex2(", "chunk ^ (r % 8)", "SplitTileCopier<CK, CK, true> h_copier"):
        assert op in text, op
    assert "mma16816(" not in text and "ldmatrix" not in text and "mma1688_tf32x3(" not in text
    assert "return dq_tf32(in, df, batch, n, cbar, c, st, s);" in src
    for gone in ("flash_attn_dq_kernel", "launch_dq(", "DISPATCH_CBAR", "kColsPerThread"):
        assert gone not in src, gone


def test_fp32_on_the_cpu_runs_the_plain_versions():
    f, g, h, do = (torch.from_numpy(x) for x in _inputs(2, 96, 8, 16, seed=3))
    attention.reset_launch_counts()
    o, lse = attention.flash_attention_forward(f, g, h)
    assert o.dtype == lse.dtype == torch.float32
    torch.testing.assert_close(o, attention.attention_core(f, g, h), rtol=0, atol=0)
    torch.testing.assert_close(lse, attention.attention_lse(f, g), rtol=0, atol=0)
    delta = torch.sum(do * o, dim=-1)
    df = attention.flash_attention_dq(f, g, h, do, lse, delta)
    torch.testing.assert_close(df, attention.flash_attention_dq_plain(f, g, h, do, lse, delta),
                               rtol=0, atol=0)
    dg, dh = attention.flash_attention_dkv(f, g, h, do, lse, delta)
    ref_dg, ref_dh = attention.flash_attention_dkv_plain(f, g, h, do, lse, delta)
    torch.testing.assert_close(dg, ref_dg, rtol=0, atol=0)
    torch.testing.assert_close(dh, ref_dh, rtol=0, atol=0)
    assert not any(attention.launch_counts.values())
    assert not any(attention.variant_counts.values())
