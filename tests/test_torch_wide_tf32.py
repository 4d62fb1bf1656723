"""The fp32 attention kernels past the register-held widths (c_bar 64, C
256) on the TF32 tensor cores, and B4 past 1024 channels in one pass over
a thread-block cluster, held on the CPU.

Both kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there). What can be held here:

- a model of the wide fp32 attention's rounding: every product as three
  TF32 products of split operands (lo hi + hi lo + hi hi, fp32 sums), the
  scores and dp summed 32 or 64 columns at a time as the launch's plan
  chunks them (each chunk's products apart, then added in fp32), the
  other side's 64-row tiles split over the
  blocks of a cluster as the launch's plan splits them on 132 SMs (each
  block a contiguous range of tiles, in order), and the blocks' partial
  outputs added in rank order (the forward's merged by their softmax
  states). Fed
  the same seeded inputs as the JAX package's Pallas ``_flash_forward``
  and ``_flash_backward`` (interpret mode, fp32), and at a ragged N as
  ``attention_core`` and its gradient, it stays within ``chip_smoke.py``'s
  fp32 ``tolerance``, its 1e-4 logsumexp check and ``grad_tolerance``; one
  TF32 product in place of three does not;
- a model of B4's one-pass order at Cout 1032 and 2048: the products of
  each type's variant (bf16: the weights' hi and lo halves; fp32: 3xTF32
  by chunks of 8 input channels), bias and leaky, each pixel's sum of
  squares over each 256-channel tile, the tiles' sums added in rank order,
  one scale and one rounding; within ``fused_conv_tolerance`` of
  ``tools/exp_fused_conv.py``'s Pallas block (interpret mode);
- the routing and the sources: fp32 past the register-held widths runs
  the 3xTF32 variant (the CUDA-core kernel and its product loop are gone),
  whose body issues the tf32 ``mma.sync`` through the helpers and splits
  its staged tiles once; B4 allocates no scratch up to 2048 channels and
  counts its launches by route; CPU tensors take the plain versions with
  no launch counted.
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
import torch.nn.functional as F  # noqa: E402

from twingan_tpu.ops import attention as jattention  # noqa: E402

from twingan_tpu_torch.ops import attention, cuda_build, fused_conv  # noqa: E402
from test_torch_attention_tf32 import mm1, mm3, split as split_tf32, tf32_rna  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132         # the H100's SMs, which the launch's split of the tiles counts
ROWS = 64         # own rows a block owns
TILE = 64         # other-side rows a tile
MAX_SPLITS = 8    # blocks of a cluster
PAIR_SMEM = 113 * 1024  # two blocks an SM up to this much shared memory
B4_TILE = fused_conv.CHANNEL_TILE
B4_CHUNK = {torch.bfloat16: 16, torch.float32: 8}  # input channels of a K chunk


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke", "chip_smoke.py")


@pytest.fixture(scope="module")
def exp():
    return _load("exp_fused_conv", os.path.join("tools", "exp_fused_conv.py"))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_of(mode: str, batch: int, n: int, c_bar: int, c: int) -> tuple:
    """The launch's plan (csrc/flash_wide.cuh's ``plan_tf32``): (chunk
    width, slices a group, groups, splits of the other side's tiles).
    192-column groups of 32-column slices let two blocks share an SM; dq
    and dkv take 256-column groups of 64-column slices where c_bar needs
    more. The splits: the fewest (a power of two, at most a cluster and the
    tiles) that fill every block slot and leave no block's chain of steps
    longer than a slot's share."""
    widest = {"fwd": c, "dq": c_bar}.get(mode, max(c_bar, c))
    tk = 64 if mode != "fwd" and c_bar > 192 else 32
    rows = ntiles = _cdiv(n, TILE)
    subs = min(_cdiv(widest, tk), (256 if tk == 64 else 192) // tk)
    while mode == "fwd" and subs > 2 and (
            rows * batch * _cdiv(c, tk * subs) * min(MAX_SPLITS, ntiles) < 2 * SMS):
        subs -= 2  # the forward recomputes only s: narrower groups at a small N
    group = tk * subs
    kdg, kdh = _cdiv(c_bar, group), _cdiv(c, group)
    groups = {"fwd": kdh, "dq": kdg}.get(mode, kdg + kdh)
    spts = []
    for z in range(groups):
        dh = mode == "fwd" or (mode == "dkv" and z >= kdg)
        width, c0 = (c, group * (z - kdg if mode == "dkv" else z)) if dh else (c_bar, group * z)
        spts.append(_cdiv(c_bar, tk) + (0 if dh else _cdiv(c, tk))
                    + _cdiv(min(group, width - c0), tk))
    stages = 3 if tk == 64 else 2
    smem = 4 * (stages * 3 * ROWS * (tk + 4) + 4 * subs * (tk // 8) * 32 * 4 + 11 * ROWS)
    slots = SMS * (2 if smem <= PAIR_SMEM else 1)
    splits = 1
    while 2 * splits <= min(MAX_SPLITS, ntiles) and (
            rows * batch * groups * splits < slots
            or max(spts) * _cdiv(ntiles, splits) * slots > rows * batch * ntiles * sum(spts)):
        splits *= 2
    return tk, subs, groups, splits


def tile_ranges(n: int, splits: int) -> list:
    """Each block's tiles, in rank order."""
    ntiles = _cdiv(n, TILE)
    return [range(k * ntiles // splits, (k + 1) * ntiles // splits) for k in range(splits)]


def chunked(mm, a, b, tk):
    """a b^T as the kernel sums it: each ``tk``-column chunk's products
    apart, added in fp32 in order."""
    out = None
    for k0 in range(0, a.shape[-1], tk):
        part = mm(a[..., k0:k0 + tk], b[..., k0:k0 + tk].transpose(-1, -2))
        out = part if out is None else out + part
    return out


def forward_model(f, g, h, mm=mm3):
    """(o, lse) as the wide fp32 forward rounds them: each block of the
    cluster an online softmax over its key tiles, the blocks' states merged
    in rank order."""
    b, n, _ = f.shape
    parts = []
    tk, _, _, splits = plan_of("fwd", b, n, f.shape[-1], h.shape[-1])
    for tiles in tile_ranges(n, splits):
        m = torch.full((b, n), -torch.inf)
        l = torch.zeros(b, n)
        acc = torch.zeros(b, n, h.shape[-1])
        for t in tiles:
            keys = slice(t * TILE, (t + 1) * TILE)
            s = chunked(mm, f, g[:, keys], tk)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            scale = torch.exp(m - m_new)
            l = l * scale + p.sum(-1)
            acc = acc * scale[..., None] + mm(p, h[:, keys])
            m = m_new
        parts.append((m, l, acc))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    l_all, o = torch.zeros_like(top), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - top)
        l_all = l_all + w * l
        o = o + w[..., None] * acc
    return o / l_all[..., None], top + torch.log(l_all)


def dq_model(f, g, h, do, lse, delta, mm=mm3):
    """df as the wide fp32 dq rounds it: each block's key tiles in order,
    the blocks' partial df added in rank order."""
    b, n, c_bar = f.shape
    df = torch.zeros_like(f)
    tk, _, _, splits = plan_of("dq", b, n, c_bar, h.shape[-1])
    for tiles in tile_ranges(n, splits):
        part = torch.zeros_like(f)
        for t in tiles:
            keys = slice(t * TILE, (t + 1) * TILE)
            p = torch.exp(chunked(mm, f, g[:, keys], tk) - lse[..., None])
            ds = p * (chunked(mm, do, h[:, keys], tk) - delta[..., None])
            part = part + mm(ds, g[:, keys])
        df = df + part
    return df


def dkv_model(f, g, h, do, lse, delta, mm=mm3):
    """(dg, dh) as the wide fp32 dkv rounds them: keys own the rows, each
    block's query tiles in order, the blocks' partial sums added in rank
    order."""
    b, n, c_bar = f.shape
    dg, dh = torch.zeros_like(g), torch.zeros_like(h)
    tk, _, _, splits = plan_of("dkv", b, n, c_bar, h.shape[-1])
    for tiles in tile_ranges(n, splits):
        pg, ph = torch.zeros_like(g), torch.zeros_like(h)
        for t in tiles:
            q = slice(t * TILE, (t + 1) * TILE)
            pt = torch.exp(chunked(mm, g, f[:, q], tk) - lse[:, None, q])
            dst = pt * (chunked(mm, h, do[:, q], tk) - delta[:, None, q])
            ph = ph + mm(pt, do[:, q])
            pg = pg + mm(dst, f[:, q])
        dg, dh = dg + pg, dh + ph
    return dg, dh


def _inputs(b, n, c_bar, c, seed):
    """Seeded numpy draws; f and g at twice unit scale, so that the scores
    are of a trained layer's size."""
    rng = np.random.RandomState(seed)
    return [(2.0 if w == c_bar else 1.0) * rng.randn(b, n, w).astype(np.float32)
            for w in (c_bar, c_bar, c, c)]


def _max_err(a, ref) -> tuple[float, float]:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max()), float(np.abs(ref).max())


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


def test_wide_model_plans_the_launch():
    """The model takes the launch's plan. At the chip rows' C 2048 (c_bar
    256) dq and dkv take 64-column chunks and hold all of c_bar in 4 slices
    so that dp is computed once, the forward 32-column slices in 11 groups
    of 6, and each block takes one of the 4 key tiles; at the ragged N 1000,
    C 512 dq holds its 2 slices (two blocks an SM) over 8 splits; the
    512-channel config's N 64 has one tile and no split, and the forward
    takes narrow groups there for blocks. At this file's
    shapes (c_bar 128: 32-column chunks) each kernel merges 4 blocks'
    partial outputs."""
    assert plan_of("dq", 2, 256, 256, 2048) == (64, 4, 1, 4)
    assert plan_of("dkv", 2, 256, 256, 2048) == (64, 4, 9, 4)
    assert plan_of("fwd", 2, 256, 256, 2048) == (32, 6, 11, 4)
    assert plan_of("dq", 2, 1000, 64, 512) == (32, 2, 1, 8)
    assert plan_of("dkv", 2, 1000, 64, 512) == (32, 6, 4, 4)
    assert plan_of("dq", 4, 64, 64, 512) == (32, 2, 1, 1)
    # The forward at the small N of the 512- and 1024-channel configs:
    # 2-slice groups, 32 and 64 blocks where 6-slice ones gave 12 and 24.
    assert plan_of("fwd", 4, 64, 64, 512) == (32, 2, 8, 1)
    assert plan_of("fwd", 4, 16, 128, 1024) == (32, 2, 16, 1)
    for mode in ("fwd", "dq", "dkv"):
        assert plan_of(mode, 1, 256, 128, 512)[0] == 32
        assert plan_of(mode, 1, 256, 128, 512)[3] == plan_of(mode, 1, 200, 128, 512)[3] == 4
    assert [list(r) for r in tile_ranges(200, 4)] == [[0], [1], [2], [3]]
    assert [list(r) for r in tile_ranges(1000, 8)][:2] == [[0, 1], [2, 3]]
    assert [list(r) for r in tile_ranges(300, 4)] == [[0], [1], [2], [3, 4]]


def test_wide_tf32x3_model_within_chip_tolerance(smoke):
    """B 1, N 256, c_bar 128, C 512 (the 1024-channel config's c_bar at
    the 512-channel config's C): the model against the Pallas forward and
    backward in interpret mode; a single TF32 product misses."""
    b, n, c_bar, c = 1, 256, 128, 512
    f, g, h, do = _inputs(b, n, c_bar, c, seed=22)
    jf, jg, jh, jdo = map(jnp.asarray, (f, g, h, do))
    o, lse = jattention._flash_forward(jf, jg, jh, 128, 128)
    refs = (o, lse, *jattention._flash_backward(jf, jg, jh, jdo, lse,
                                                jnp.sum(jdo * o, axis=-1), 128, 128))
    errs = _model_errors(smoke, f, g, h, do, refs, mm3)
    assert all(0 < err <= limit for err, limit in errs.values()), errs
    single = _model_errors(smoke, f, g, h, do, refs, mm1)
    assert single["o"][0] > single["o"][1] and single["df"][0] > single["df"][1], single
    assert max(err / limit for err, limit in single.values()) > 4, single


def test_wide_tf32x3_model_at_ragged_n(smoke):
    """N 200 (a last tile of 8 rows on either side, 4 blocks a cluster) at
    c_bar 128, C 512: against attention_core and jax.grad of it in fp32."""
    b, n, c_bar, c = 1, 200, 128, 512
    f, g, h, do = _inputs(b, n, c_bar, c, seed=23)
    jf, jg, jh, jdo = map(jnp.asarray, (f, g, h, do))
    ref_o = jattention.attention_core(jf, jg, jh)
    ref_lse = jax.nn.logsumexp(jnp.einsum("bic,bjc->bij", jf, jg), axis=-1)
    grads = jax.grad(lambda *a: jnp.sum(jattention.attention_core(*a) * jdo),
                     argnums=(0, 1, 2))(jf, jg, jh)
    errs = _model_errors(smoke, f, g, h, do, (ref_o, ref_lse, *grads), mm3)
    assert all(0 < err <= limit for err, limit in errs.values()), errs


def b4_splits(cin: int, cout: int, dtype, batch: int = 1) -> int:
    """The plan's split of Cin's chunks at 16 pixels or fewer (one pixel
    tile an image): the fewest that give every SM a block, at most 16
    blocks a cluster of channel tiles (the card held every such cluster)."""
    chunks, tiles = _cdiv(cin, B4_CHUNK[dtype]), _cdiv(cout, B4_TILE)
    most, splits = min(chunks, 16 // tiles), 1
    while batch * tiles * splits < SMS and splits < most:
        splits += 1
    return _cdiv(chunks, _cdiv(chunks, splits))


def b4_one_pass_model(x, w9, b, dtype, products=3):
    """y as B4's one pass rounds it past 1024 channels at 4 px: the
    products of the type's variant (bf16: x times the weights' bf16 hi and
    lo halves; fp32: 3xTF32, each chunk of 8 input channels summed apart
    and added in fp32), Cin's chunks cut into the plan's splits whose
    partial sums are added in rank order, bias and leaky, each pixel's sum
    of squares over each 256-channel tile, the tiles' sums added in rank
    order, one scale, y rounded once."""
    cin, cout = w9.shape[1:]
    chunk = B4_CHUNK[dtype]
    chunks = _cdiv(cin, chunk)
    per_split = _cdiv(chunks, b4_splits(cin, cout, dtype, x.shape[0]))

    def conv(xs, ws, ci):
        return F.conv2d(xs[:, ci], ws[:, ci].reshape(3, 3, -1, cout).permute(3, 2, 0, 1),
                        padding=1)

    if dtype == torch.bfloat16:
        hi = w9.to(torch.bfloat16).float()
        halves = (hi, (w9 - hi).to(torch.bfloat16).float())
    else:
        (xh, xl), (wh, wl) = split_tf32(x), split_tf32(w9)
    total = None
    for c0 in range(0, chunks, per_split):
        if dtype == torch.bfloat16:
            ci = slice(c0 * chunk, (c0 + per_split) * chunk)
            part = sum(conv(x, half, ci) for half in halves)
        else:
            part = None
            for c in range(c0, min(c0 + per_split, chunks)):
                ci = slice(c * chunk, (c + 1) * chunk)
                prod = ((conv(xl, wh, ci) + conv(xh, wl, ci)) + conv(xh, wh, ci) if products == 3
                        else conv(tf32_rna(x), tf32_rna(w9), ci))
                part = prod if part is None else part + prod
        total = part if total is None else total + part
    v = total + b[:, None, None]
    v = torch.maximum(v * fused_conv.LEAKY_SLOPE, v)
    ssq = torch.zeros_like(v[:, :1])
    for c0 in range(0, cout, B4_TILE):  # the cluster's channel tiles, in rank order
        ssq = ssq + torch.sum(torch.square(v[:, c0:c0 + B4_TILE]), dim=1, keepdim=True)
    y = v * torch.rsqrt(ssq / cout + fused_conv.PIXEL_NORM_EPS)
    return y.to(dtype).float()


def test_b4_plan_splits_small_layers():
    """At 4 px the one-pass clusters also split K: 1032 channels (5 tiles)
    3 ways, 2048 (8 tiles) 2 ways; the test's Cin 40 has 3 bf16 chunks and
    5 fp32 ones (3 splits of 2, 2 and 1)."""
    assert b4_splits(1032, 1032, torch.bfloat16, 2) == 3
    assert b4_splits(2048, 2048, torch.float32, 2) == 2
    assert b4_splits(40, 1032, torch.bfloat16) == 3 and b4_splits(40, 1032, torch.float32) == 3
    assert b4_splits(40, 2048, torch.float32) == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("cout", [1032, 2048])
def test_b4_one_pass_model_within_chip_tolerance(exp, smoke, cout, dtype):
    """4 px, B 1, Cin 40 (three bf16 chunks, five fp32 ones, split as the
    plan splits them): Cout 1032 (5 tiles, the last of 8 channels) and 2048
    (8 tiles, the widest one pass)
    against the Pallas block on the same bf16-valued x; fp32 also on x
    that bf16 does not hold, against the plain version, where one TF32
    product misses."""
    rng = np.random.RandomState(cout)
    cin = 40
    x = torch.from_numpy(rng.rand(1, 4, 4, cin).astype(np.float32)).to(torch.bfloat16).float()
    w = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(exp.pallas_block(jnp.asarray(x.numpy()).astype(jdtype), jnp.asarray(w),
                                      jnp.asarray(bias)).astype(jnp.float32))
    w9, bt = torch.from_numpy(w.reshape(9, cin, cout)), torch.from_numpy(bias)
    y = b4_one_pass_model(x.permute(0, 3, 1, 2).contiguous(), w9, bt, dtype)
    name = "float32" if dtype == torch.float32 else "bfloat16"
    err = float(np.abs(y.permute(0, 2, 3, 1).numpy() - ref).max())
    tol = smoke.fused_conv_tolerance(name, float(np.abs(ref).max()))
    assert err <= tol, (err, tol)
    if dtype == torch.float32:
        xr = torch.from_numpy(rng.randn(1, cin, 4, 4).astype(np.float32))
        plain = fused_conv.fused_conv_plain(xr, w9, bt)
        tol = smoke.fused_conv_tolerance(name, float(plain.abs().max()))
        assert float((b4_one_pass_model(xr, w9, bt, dtype) - plain).abs().max()) <= tol
        assert float((b4_one_pass_model(xr, w9, bt, dtype, 1) - plain).abs().max()) > 4 * tol


def _source(name: str) -> str:
    with open(os.path.join(cuda_build.CSRC_DIR, name)) as fh:
        return fh.read()


def test_wide_fp32_runs_the_tf32x3_variant(smoke):
    """fp32 past c_bar 64 or C 256 takes the 3xTF32 variant, which the
    entry points report for it as for the register-held kernels; the
    chip rows expect it."""
    for kernel in (attention.KERNEL_NAME, attention.DQ_KERNEL, attention.DKV_KERNEL):
        assert attention.WIDE_VARIANTS[kernel][torch.float32] == attention.TF32X3
        for c_bar, c in ((64, 512), (128, 1024), (256, 2048)):
            assert smoke.expected_variant(kernel, torch.float32, c_bar, c) == attention.TF32X3
    assert not any(k.endswith("/" + attention.CUDA_CORE) for k in attention.variant_counts)
    for name in ("flash_attn_fwd.cu", "flash_attn_bwd.cu"):
        assert "kCudaCore" not in _source(name)


def test_wide_fp32_body_issues_tf32_mma():
    """The wide fp32 body issues the tf32 mma.sync for its products (the
    score and dp chunks; the value or gradient slice), each as lo hi, hi
    lo and hi hi; splits each staged B or V chunk once in shared memory and
    the A fragments and P or ds once a tile in registers; sums the
    cluster's blocks through distributed shared memory; the CUDA-core
    kernel and its FMA loop are gone."""
    src = _source("flash_wide.cuh")
    body = src[src.index("wide_tf32_kernel(Args<float> p"):src.index("cudaError_t launch_tf32(")]
    calls = re.findall(r"mma1688_tf32\(part\[jj\], (\w+(?:\[kk\])?)\.(lo|hi), (b[hl])r", body)
    assert [(part, b) for _, part, b in calls] == [("lo", "bh"), ("hi", "bl"), ("hi", "bh")] * 2
    for op in ("split_chunk<kTK>(bh, bl, vec, tid)", "split_frag(a[0], a[8 * kTS], a[4], a[8 * kTS + 4])",
               "split_frag(s[kk][0], s[kk][2], s[kk][1], s[kk][3])", "cp_async_wait<kStages - 2>()",
               "cluster_sync(splits)", "peer_sources(srcs, accs, splits)",
               "ex2("):
        assert op in body, op
    assert "split_tf32(v.x)" in src and "cp_async16(" in src and "map_shared_rank(" in src
    assert "srcs[k] = k < splits ? peer(accs, k, splits) : accs" in src
    assert "cudaLaunchAttributeClusterDimension" in src
    for gone in ("wide_fp32_kernel", "fma_abt", "kF32Threads", "atomicAdd"):
        assert gone not in src, gone
    assert "mma16816(" not in body and "ldmatrix" not in body


def test_b4_source_runs_one_pass_over_a_cluster():
    """B4 past 1024 channels: tiles of 256 channels, one cluster a pixel
    tile up to 8 tiles, each block adding every tile's row sums through
    distributed shared memory in rank order; two passes only past it."""
    src = _source("fused_conv.cu")
    for op in ("constexpr int kChannelTile = 256;", "constexpr int kMaxCluster = 8;",
               "constexpr int kOnePassWidth = kMaxCluster * kChannelTile;",
               "if (rank < cct) total += cg::this_cluster().map_shared_rank(rss, rank)[m]",
               "plan.tile.cluster_ct = cout <= kOnePassWidth ? ctiles : 1;",
               "cluster[0].val.clusterDim.x = plan.tile.cluster_ct;",
               "(cout > kOnePassWidth) != two_pass"):
        assert op in src, op
    assert "atomicAdd" not in src and "kPassTile" not in src


@pytest.mark.parametrize("cout,dtype,scratch", [
    (1032, torch.bfloat16, False), (2048, torch.bfloat16, False), (2048, torch.float32, False),
    (2056, torch.bfloat16, True), (2056, torch.float32, True)])
def test_b4_scratch_only_past_one_pass(cout, dtype, scratch):
    """The wrapper allocates the two passes' workspace and sums of squares
    only past ONE_PASS_WIDTH channels (the fp32 workspace is y itself)."""
    y = torch.empty(2, cout, 4, 4, dtype=dtype)
    ws, ssq = fused_conv._scratch(y)
    assert (ws is not None, ssq is not None) == (scratch, scratch)
    if scratch:
        assert ws.dtype == torch.float32 and ws.shape == y.shape
        assert (ws is y) == (dtype == torch.float32)
        assert tuple(ssq.shape) == (_cdiv(cout, fused_conv.CHANNEL_TILE), 2, 16)
    assert fused_conv.ONE_PASS_WIDTH == 2048 == 8 * fused_conv.CHANNEL_TILE


def test_b4_counts_launches_by_route():
    fused_conv.reset_launch_counts()
    try:
        fused_conv._count(ctypes.c_int(1))
        fused_conv._count(ctypes.c_int(2), two_pass=True)
        assert fused_conv.route_counts == {fused_conv.ONE_PASS: 1, fused_conv.TWO_PASS: 1}
        assert fused_conv.launch_counts[fused_conv.KERNEL_NAME] == 2
    finally:
        fused_conv.reset_launch_counts()
    assert not any(fused_conv.route_counts.values())


def test_wide_cpu_tensors_take_the_plain_versions():
    """fp32 at C 512, c_bar 64 (attention) and Cout 1032 (B4) on the CPU:
    the plain versions, exactly, and no launch counted."""
    f, g, h, do = (torch.from_numpy(x) for x in _inputs(1, 64, 64, 512, seed=24))
    attention.reset_launch_counts()
    fused_conv.reset_launch_counts()
    o, lse = attention.flash_attention_forward(f, g, h)
    torch.testing.assert_close(o, attention.attention_core(f, g, h), rtol=0, atol=0)
    delta = torch.sum(do * o, dim=-1)
    dg, dh = attention.flash_attention_dkv(f, g, h, do, lse, delta)
    torch.testing.assert_close(dh, attention.flash_attention_dkv_plain(f, g, h, do, lse, delta)[1],
                               rtol=0, atol=0)
    x = torch.randn(1, 8, 4, 4, generator=torch.Generator().manual_seed(0))
    w9, b = torch.randn(9, 8, 1032) * 0.1, torch.zeros(1032)
    torch.testing.assert_close(fused_conv.fused_conv(x, w9, b),
                               fused_conv.fused_conv_plain(x, w9, b), rtol=0, atol=0)
    assert not any(attention.launch_counts.values())
    assert not any(fused_conv.launch_counts.values())
    assert not any(fused_conv.route_counts.values())
