"""The tensor-core (bf16) variants of the flash-attention forward, dq and
dkv kernels, checked on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there). What can be held here, before any card time:

- a model of their rounding: the forward rounds each 64-key tile's
  probabilities to bf16 against that tile's running max (two warps take
  alternate tiles of each row and merge at the end), sums l from the fp32
  probabilities and rounds the output once; dkv rounds P and dS to bf16
  as product operands per 64-query tile (two warps take alternate tiles)
  and sums in fp32; dq rounds dS to bf16 per 64-key tile (two warps take
  alternate tiles) and sums in fp32. Fed the same seeded inputs (bf16 values) as the JAX
  package's ``attention_core`` and its Pallas ``_flash_forward`` /
  ``_flash_backward`` (interpret mode, fp32), the model stays within
  ``chip_smoke.py``'s ``tolerance("bfloat16", ...)``, its 1e-4 logsumexp
  check and its ``grad_tolerance("bfloat16", ...)``;
- the sources: plain C entry points, no PyTorch headers, the TPU kernels
  they replace named, the bf16 path on ``mma.sync``;
- the routing on the CPU: the plain versions, no launch counted.
"""

import ctypes
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
TILE = 64   # keys (forward, dq) or queries (dkv) per warp and tile
SPLIT = 2   # warps sharing one row's tiles, taking alternate ones


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


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16 (nearest even), kept in fp32."""
    return x.to(torch.bfloat16).float()


def _inputs(b, n, c_bar, c, seed):
    """Seeded numpy draws rounded to bf16 values: what the card's bf16
    tensors hold, in fp32 for both packages."""
    rng = np.random.RandomState(seed)
    draw = [rng.randn(b, n, w).astype(np.float32) for w in (c_bar, c_bar, c, c)]
    return [_bf16(torch.from_numpy(x)).numpy() for x in draw]


def mma_forward_model(f, g, h):
    """(o, lse) as the tensor-core forward rounds them (fp32 tensors)."""
    b, n, _ = f.shape
    s_all = f @ g.transpose(1, 2)
    parts = []
    for half in range(SPLIT):
        m = torch.full((b, n), -torch.inf)
        l = torch.zeros(b, n)
        acc = torch.zeros(b, n, h.shape[-1])
        for i, k0 in enumerate(range(0, n, TILE)):
            if i % SPLIT != half:
                continue
            s = s_all[:, :, k0:k0 + TILE]
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            scale = torch.exp(m - m_new)
            l = l * scale + p.sum(-1)
            acc = acc * scale[..., None] + _bf16(p) @ h[:, k0:k0 + TILE]
            m = m_new
        parts.append((m, l, acc))
    (m0, l0, a0), (m1, l1, a1) = parts
    m = torch.maximum(m0, m1)
    w0, w1 = torch.exp(m0 - m), torch.exp(m1 - m)  # the second half may hold no key
    l = w0 * l0 + w1 * l1
    acc = w0[..., None] * a0 + w1[..., None] * a1
    return _bf16(acc / l[..., None]), m + torch.log(l)


def mma_dkv_model(f, g, h, do, lse, delta):
    """(dg, dh) as the tensor-core dkv rounds them (fp32 tensors)."""
    n = f.shape[1]
    p = torch.exp(f @ g.transpose(1, 2) - lse[..., None])
    ds = p * (do @ h.transpose(1, 2) - delta[..., None])
    dg = [torch.zeros_like(g) for _ in range(SPLIT)]
    dh = [torch.zeros_like(h) for _ in range(SPLIT)]
    for i, q0 in enumerate(range(0, n, TILE)):
        q = slice(q0, q0 + TILE)
        dh[i % SPLIT] += _bf16(p[:, q]).transpose(1, 2) @ do[:, q]
        dg[i % SPLIT] += _bf16(ds[:, q]).transpose(1, 2) @ f[:, q]
    return _bf16(dg[0] + dg[1]), _bf16(dh[0] + dh[1])


def mma_dq_model(f, g, h, do, lse, delta):
    """df as the tensor-core dq rounds it (fp32 tensors): dS rounded to bf16
    per 64-key tile as the product's operand, the two warps' fp32 sums
    added in a fixed order, df rounded once."""
    n = f.shape[1]
    p = torch.exp(f @ g.transpose(1, 2) - lse[..., None])
    ds = p * (do @ h.transpose(1, 2) - delta[..., None])
    df = [torch.zeros_like(f) for _ in range(SPLIT)]
    for i, k0 in enumerate(range(0, n, TILE)):
        k = slice(k0, k0 + TILE)
        df[i % SPLIT] += _bf16(ds[:, :, k]) @ g[:, k]
    return _bf16(df[0] + df[1])


def _max_err(a, ref) -> tuple[float, float]:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max()), float(np.abs(ref).max())


@pytest.mark.parametrize("b,n,c_bar,c", [(2, 512, 8, 64), (1, 512, 32, 256)])
def test_forward_rounding_model_within_chip_tolerance(smoke, b, n, c_bar, c):
    """The model against the Pallas forward (interpret mode, fp32) on the
    same bf16-valued inputs: output within tolerance("bfloat16") and the
    logsumexp within chip_smoke.py's 1e-4 of its magnitude."""
    f, g, h, _ = _inputs(b, n, c_bar, c, seed=n + c)
    ref_o, ref_lse = jattention._flash_forward(*map(jnp.asarray, (f, g, h)), 128, 128)
    o, lse = mma_forward_model(*map(torch.from_numpy, (f, g, h)))
    err, ref_max = _max_err(o, ref_o)
    assert 0 < err <= smoke.tolerance("bfloat16", ref_max), (err, ref_max)
    lse_err, lse_max = _max_err(lse, ref_lse)
    assert lse_err <= 1e-4 * max(1.0, lse_max), lse_err
    # The einsum path agrees with the Pallas kernel it stands beside.
    np.testing.assert_allclose(np.asarray(jattention.attention_core(
        *map(jnp.asarray, (f, g, h)))), np.asarray(ref_o), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,n,c_bar,c", [(2, 512, 8, 64), (1, 256, 32, 256)])
def test_dkv_rounding_model_within_chip_tolerance(smoke, b, n, c_bar, c):
    """The kernels' path (the forward model's bf16 output and lse, delta =
    rowsum(do o), the dkv model) against the Pallas backward (interpret
    mode, fp32, from its own forward): dg and dh within
    grad_tolerance("bfloat16")."""
    f, g, h, do = _inputs(b, n, c_bar, c, seed=n + c + 1)
    jf, jg, jh, jdo = map(jnp.asarray, (f, g, h, do))
    ref_o, ref_lse = jattention._flash_forward(jf, jg, jh, 128, 128)
    ref_delta = jnp.sum(jdo * ref_o, axis=-1)
    _, ref_dg, ref_dh = jattention._flash_backward(jf, jg, jh, jdo, ref_lse, ref_delta, 128, 128)
    tf, tg, th, tdo = map(torch.from_numpy, (f, g, h, do))
    o, lse = mma_forward_model(tf, tg, th)
    dg, dh = mma_dkv_model(tf, tg, th, tdo, lse, torch.sum(tdo * o, dim=-1))
    for name, out, ref in (("dg", dg, ref_dg), ("dh", dh, ref_dh)):
        err, ref_max = _max_err(out, ref)
        assert 0 < err <= smoke.grad_tolerance("bfloat16", ref_max, n), (name, err, ref_max)


@pytest.mark.parametrize("b,n,c_bar,c", [(2, 512, 8, 64), (1, 256, 32, 256)])
def test_dq_rounding_model_within_chip_tolerance(smoke, b, n, c_bar, c):
    """The kernels' path (the forward model's bf16 output and lse, delta =
    rowsum(do o), the dq model) against the Pallas backward's df (interpret
    mode, fp32, from its own forward): within grad_tolerance("bfloat16")."""
    f, g, h, do = _inputs(b, n, c_bar, c, seed=n + c + 2)
    jf, jg, jh, jdo = map(jnp.asarray, (f, g, h, do))
    ref_o, ref_lse = jattention._flash_forward(jf, jg, jh, 128, 128)
    ref_delta = jnp.sum(jdo * ref_o, axis=-1)
    ref_df, _, _ = jattention._flash_backward(jf, jg, jh, jdo, ref_lse, ref_delta, 128, 128)
    tf, tg, th, tdo = map(torch.from_numpy, (f, g, h, do))
    o, lse = mma_forward_model(tf, tg, th)
    df = mma_dq_model(tf, tg, th, tdo, lse, torch.sum(tdo * o, dim=-1))
    err, ref_max = _max_err(df, ref_df)
    assert 0 < err <= smoke.grad_tolerance("bfloat16", ref_max, n), (err, ref_max)


def test_dq_rounding_model_at_ragged_n(smoke):
    """N 1000, the ragged case of chip_smoke.py's BWD_CASES (a last key tile
    of 40 keys, taken by the first warp): against jax.grad of the einsum
    path in fp32."""
    b, n, c_bar, c = 1, 1000, 8, 64
    f, g, h, do = _inputs(b, n, c_bar, c, seed=8)
    jf, jg, jh, jdo = map(jnp.asarray, (f, g, h, do))
    ref_df = jax.grad(lambda q: jnp.sum(jattention.attention_core(q, jg, jh) * jdo))(jf)
    tf, tg, th, tdo = map(torch.from_numpy, (f, g, h, do))
    o, lse = mma_forward_model(tf, tg, th)
    df = mma_dq_model(tf, tg, th, tdo, lse, torch.sum(tdo * o, dim=-1))
    err, ref_max = _max_err(df, ref_df)
    assert 0 < err <= smoke.grad_tolerance("bfloat16", ref_max, n), (err, ref_max)


def test_rounding_models_at_ragged_n(smoke):
    """N 200 (a last tile of 8 keys; the JAX flash kernels reject it):
    against jax.grad of the einsum path in fp32."""
    b, n, c_bar, c = 2, 200, 8, 64
    f, g, h, do = _inputs(b, n, c_bar, c, seed=7)
    jf, jg, jh, jdo = map(jnp.asarray, (f, g, h, do))
    ref_o = jattention.attention_core(jf, jg, jh)
    _, ref_dg, ref_dh = jax.grad(lambda *a: jnp.sum(jattention.attention_core(*a) * jdo),
                                 argnums=(0, 1, 2))(jf, jg, jh)
    tf, tg, th, tdo = map(torch.from_numpy, (f, g, h, do))
    o, lse = mma_forward_model(tf, tg, th)
    err, ref_max = _max_err(o, ref_o)
    assert err <= smoke.tolerance("bfloat16", ref_max)
    dg, dh = mma_dkv_model(tf, tg, th, tdo, lse, torch.sum(tdo * o, dim=-1))
    for out, ref in ((dg, ref_dg), (dh, ref_dh)):
        err, ref_max = _max_err(out, ref)
        assert err <= smoke.grad_tolerance("bfloat16", ref_max, n)


def _source(name: str) -> str:
    with open(os.path.join(cuda_build.CSRC_DIR, name)) as fh:
        return fh.read()


@pytest.mark.parametrize("name,entry,replaces", [
    ("flash_attn_fwd.cu", 'extern "C" int flash_attn_fwd(', "_flash_kernel"),
    ("flash_attn_bwd.cu", 'extern "C" int flash_attn_dkv(', "_flash_dkv_kernel"),
    ("flash_attn_bwd.cu", 'extern "C" int flash_attn_dq(', "_flash_dq_kernel"),
])
def test_tensor_core_sources(name, entry, replaces):
    src = _source(name)
    assert entry in src
    assert "torch/extension.h" not in src and "ATen" not in src
    assert replaces in src  # names the TPU kernel it replaces
    assert '#include "flash_mma.cuh"' in src
    assert "mma1688(" in src and "mma16816(" in src and "ldmatrix_x4_trans(" in src
    header = _source("flash_mma.cuh")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in header
    assert "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32" in header
    assert "ldmatrix.sync.aligned" in header and "cp.async.cg.shared.global" in header
    assert "#include <torch" not in header and "ATen" not in header


def test_dq_kernel_runs_on_mma():
    """The bf16 dq kernel is the tensor-core one: its body recomputes P with
    ex2, forms dP and df on mma.sync, reads g transposed by ldmatrix, and
    the C entry point sends bf16 to it."""
    src = _source("flash_attn_bwd.cu")
    body = src[src.index("flash_attn_dq_mma_kernel("):src.index("cudaError_t launch_dq_mma(")]
    for op in ("mma1688(", "mma16816(", "ldmatrix_x4(", "ldmatrix_x2_trans(",
               "ldmatrix_x4_trans(", "ex2(", "TileCopier<", "cp_async_commit()"):
        assert op in body, op
    assert "if (dtype == 1) return dq_mma(" in src


def test_variants_by_type():
    """bf16 takes the tensor-core variant of each of the three kernels; fp32
    the 3xTF32 tensor-core variant of each; past the register-held widths,
    the wide kernels: the bf16 forward on the tensor cores, the bf16 dq and
    dkv on the tensor cores as the cluster variant, fp32 on the TF32 tensor
    cores: no kernel runs on the CUDA cores. The C entry points pick the
    variant and report it by the ids of ``VARIANT_IDS``, which the counts
    record."""
    v = attention.VARIANTS
    assert v[attention.KERNEL_NAME] == v[attention.DQ_KERNEL] == v[attention.DKV_KERNEL] == {
        torch.float32: attention.TF32X3, torch.bfloat16: attention.TENSOR_CORE}
    assert attention.WIDE_VARIANTS == {
        attention.KERNEL_NAME: {torch.float32: attention.TF32X3,
                                torch.bfloat16: attention.TENSOR_CORE},
        attention.DQ_KERNEL: {torch.float32: attention.TF32X3,
                              torch.bfloat16: attention.TENSOR_CORE_CLUSTER},
        attention.DKV_KERNEL: {torch.float32: attention.TF32X3,
                               torch.bfloat16: attention.TENSOR_CORE_CLUSTER}}
    assert set(attention.variant_counts) == {
        "flash_attn_fwd/tensor_core_tf32x3", "flash_attn_fwd/tensor_core",
        "flash_attn_dq/tensor_core_tf32x3", "flash_attn_dq/tensor_core",
        "flash_attn_dq/tensor_core_cluster",
        "flash_attn_dkv/tensor_core_tf32x3", "flash_attn_dkv/tensor_core",
        "flash_attn_dkv/tensor_core_cluster"}
    enum = re.search(r"enum Variant : int \{([^}]*)\}", _source("flash_mma.cuh")).group(1)
    ids = dict(re.findall(r"(k\w+) = (\d+)", enum))
    assert {attention.VARIANT_IDS[int(i)]: k for k, i in ids.items()} == {
        attention.CUDA_CORE: "kCudaCore", attention.TENSOR_CORE: "kTensorCore",
        attention.TF32X3: "kTf32x3", attention.TENSOR_CORE_CLUSTER: "kTensorCoreCluster"}
    fwd, bwd = _source("flash_attn_fwd.cu"), _source("flash_attn_bwd.cu")
    for src, entry in ((fwd, "flash_attn_fwd("), (bwd, "flash_attn_dq("),
                       (bwd, "flash_attn_dkv(")):
        head = src[src.index(f'extern "C" int {entry}'):]
        assert "void* stream, int* variant)" in head[:head.index("{")]
    assert fwd.count("*variant = ") == 1 and bwd.count("*variant = ") == 2
    assert "kCudaCore" not in fwd + bwd
    attention.reset_launch_counts()
    try:
        attention._count(attention.DKV_KERNEL, ctypes.c_int(2))
        assert attention.variant_counts["flash_attn_dkv/tensor_core_tf32x3"] == 1
        assert attention.launch_counts[attention.DKV_KERNEL] == 1
        with pytest.raises(RuntimeError, match="reported no variant"):
            attention._count(attention.KERNEL_NAME, ctypes.c_int(-1))
        assert attention.launch_counts[attention.KERNEL_NAME] == 0
    finally:
        attention.reset_launch_counts()


def test_bf16_on_the_cpu_runs_the_plain_versions():
    f, g, h, do = (torch.from_numpy(x).bfloat16() for x in _inputs(2, 96, 8, 16, seed=3))
    attention.reset_launch_counts()
    o, lse = attention.flash_attention_forward(f, g, h)
    torch.testing.assert_close(o, attention.attention_core(f, g, h), rtol=0, atol=0)
    torch.testing.assert_close(lse, attention.attention_lse(f, g), rtol=0, atol=0)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    df = attention.flash_attention_dq(f, g, h, do, lse, delta)
    assert df.dtype == torch.bfloat16
    torch.testing.assert_close(df, attention.flash_attention_dq_plain(f, g, h, do, lse, delta),
                               rtol=0, atol=0)
    dg, dh = attention.flash_attention_dkv(f, g, h, do, lse, delta)
    ref_dg, ref_dh = attention.flash_attention_dkv_plain(f, g, h, do, lse, delta)
    assert dg.dtype == dh.dtype == torch.bfloat16
    torch.testing.assert_close(dg, ref_dg, rtol=0, atol=0)
    torch.testing.assert_close(dh, ref_dh, rtol=0, atol=0)
    assert not any(attention.launch_counts.values())
    assert not any(attention.variant_counts.values())
