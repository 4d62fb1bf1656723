"""The bf16 dq (B2) and dkv (B3) kernel past the register-held widths (c_bar
64, C 256), ``csrc/flash_wide.cuh``'s ``wide_bf16_kernel``, held on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against the
plain versions there). What can be held here:

- the launch's plan (``plan_bf16``) at the chip rows' shapes on 132 SMs:
  groups of up to four 64-column slices holding all of c_bar up to 256, the
  other side's tiles split over a cluster, or, at one or two tiles, dp's
  chunks and the group's slices, and the own rows' chunks kept resident
  where a block walks several tiles;
- a model of the kernel's order of operations: bf16 operands with fp32
  sums, the scores and dp summed 64 columns at a time, P and ds rounded to
  bf16 only as the last product's operand, each block's tiles in order;
  with the tiles split, the blocks' partial outputs added in rank order
  and rounded once; with dp split, the blocks' partial dp added in rank
  order before ds. Fed the same seeded bf16-valued inputs as the JAX
  package's Pallas ``_flash_backward`` (interpret mode, fp32), and at a
  ragged N ``attention_core``'s gradient, it stays within ``chip_smoke.py``'s
  bf16 ``grad_tolerance``;
- the sources and the routing: the entry points report the cluster
  variant for bf16 past those widths, ``wide_mma_kernel`` keeps only its
  forward instance, and nothing adds atomically.
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
SMS = 132         # the H100's SMs, which the launch's plan counts
ROWS = TILE = 64  # own rows a block owns; other-side rows a tile
K = 64            # columns of a chunk and of an output slice
MAX_SUBS = 4      # slices of the widest group
MAX_SPLITS = 8    # blocks of a cluster
STAGES = 5        # staging buffers
CHUNK_BYTES = ROWS * K * 2  # a staged chunk, unpadded
UNIT_BYTES = 4 * 8 * 32 * 16  # a slice's fp32 accumulators, float4 a lane
PAIR_SMEM = 113 * 1024


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_of(mode: str, batch: int, n: int, c_bar: int, c: int) -> dict:
    """csrc/flash_wide.cuh's ``plan_bf16`` on 132 SMs: the slices of dq's
    and dkv's dg groups and of dkv's dh groups, the groups, the cluster's
    blocks, whether they split dp's chunks (``dsplit``) or the tiles, and
    whether the A chunks stay resident."""
    kcb, kcc = _cdiv(c_bar, K), _cdiv(c, K)
    subs = min(kcb, MAX_SUBS)  # dq's and dkv's dg groups: all of c_bar up to 256 columns
    dh_subs = min(kcc, MAX_SUBS) if mode == "dkv" else 0
    kdg = _cdiv(c_bar, K * subs)
    kdh = _cdiv(c, K * dh_subs) if mode == "dkv" else 0
    groups = kdg + kdh
    rows = ntiles = _cdiv(n, TILE)
    blocks, slots = rows * batch * groups, 2 * SMS
    splits = 1
    if ntiles <= 2:
        while 2 * splits <= min(MAX_SPLITS, kcc) and blocks * 2 * splits <= slots:
            splits *= 2
    dsplit = splits > 1
    if not dsplit:
        spts = []
        for z in range(groups):
            dh = z >= kdg
            group = K * (dh_subs if dh else subs)
            width, c0 = (c, group * (z - kdg)) if dh else (c_bar, group * z)
            spts.append(kcb + (0 if dh else kcc) + _cdiv(min(group, width - c0), K))
        steps = rows * batch * ntiles * sum(spts)
        while 2 * splits <= min(MAX_SPLITS, ntiles) and (  # one slot an SM
                blocks * splits < SMS or max(spts) * _cdiv(ntiles, splits) * SMS > steps):
            splits *= 2
    res_smem = max((STAGES + kcb + kcc) * CHUNK_BYTES, MAX_SUBS * UNIT_BYTES)
    a_res = not dsplit and _cdiv(ntiles, splits) >= 2 and res_smem <= PAIR_SMEM
    return {"subs": subs, "dh_subs": dh_subs, "groups": groups, "splits": splits,
            "dsplit": dsplit, "a_res": a_res}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def chunked(a, b, lo: int = 0, hi: int = None):
    """a b^T over the 64-column chunks [lo, hi) in order, fp32 sums."""
    hi = _cdiv(a.shape[-1], K) if hi is None else hi
    out = torch.zeros(*a.shape[:-1], b.shape[-2])
    for k in range(lo, hi):
        out = out + a[..., K * k:K * (k + 1)] @ b[..., K * k:K * (k + 1)].transpose(-1, -2)
    return out


def _ranges(total: int, parts: int) -> list:
    return [range(k * total // parts, (k + 1) * total // parts) for k in range(parts)]


def backward_model(mode, f, g, h, do, lse, delta):
    """dq's df, or dkv's (dg, dh), as the kernel orders and rounds them:
    rows of the own side (queries for dq, keys for dkv) against each tile
    of the other side; s and dp in fp32 chunk by chunk (with dp split, the
    blocks' partial dp over their chunk ranges added in rank order); P and
    ds rounded to bf16 as the last product's operand; with the tiles split,
    each block's tiles in order and the blocks' sums added in rank order;
    each output rounded once."""
    b, n, c_bar = f.shape
    c = h.shape[-1]
    plan = plan_of(mode, b, n, c_bar, c)
    splits, kcc = plan["splits"], _cdiv(c, K)
    own_s, other_s = (f, g) if mode == "dq" else (g, f)
    own_d, other_d = (do, h) if mode == "dq" else (h, do)
    outs = [torch.zeros_like(f)] if mode == "dq" else [torch.zeros_like(g), torch.zeros_like(h)]
    tiles = [range(_cdiv(n, TILE))] if plan["dsplit"] else _ranges(_cdiv(n, TILE), splits)
    for rank_tiles in tiles:
        parts = [torch.zeros_like(o) for o in outs]
        for t in rank_tiles:
            o = slice(t * TILE, (t + 1) * TILE)
            s = chunked(own_s, other_s[:, o])
            if plan["dsplit"]:
                dp = torch.zeros_like(s)
                for chunks in _ranges(kcc, splits):
                    dp = dp + chunked(own_d, other_d[:, o], chunks.start, chunks.stop)
            else:
                dp = chunked(own_d, other_d[:, o])
            if mode == "dq":
                p = torch.exp(s - lse[..., None])
                ds = p * (dp - delta[..., None])
                parts[0] = parts[0] + _bf16(ds) @ g[:, o]
            else:
                p = torch.exp(s - lse[:, None, o])
                ds = p * (dp - delta[:, None, o])
                parts[0] = parts[0] + _bf16(ds) @ f[:, o]
                parts[1] = parts[1] + _bf16(p) @ do[:, o]
        outs = [out + part for out, part in zip(outs, parts)]
    return [_bf16(out) for out in outs]


def _inputs(b, n, c_bar, c, seed):
    """Seeded numpy draws rounded to bf16 values; f and g at twice unit
    scale, so that the scores are of a trained layer's size."""
    rng = np.random.RandomState(seed)
    return [_bf16(torch.from_numpy((2.0 if w == c_bar else 1.0)
                                   * rng.randn(b, n, w).astype(np.float32))).numpy()
            for w in (c_bar, c_bar, c, c)]


def _errors(smoke, f, g, h, do, lse, delta, refs) -> dict:
    """Each gradient of the model against ``refs`` (df, dg, dh) beside its
    chip_smoke.py limit."""
    n = f.shape[1]
    tf, tg, th, tdo, tlse, tdelta = (torch.from_numpy(np.array(x, np.float32))
                                     for x in (f, g, h, do, lse, delta))
    got = [*backward_model("dq", tf, tg, th, tdo, tlse, tdelta),
           *backward_model("dkv", tf, tg, th, tdo, tlse, tdelta)]
    errs = {}
    for name, out, ref in zip(("df", "dg", "dh"), got, refs):
        ref = np.asarray(ref, np.float64)
        err, ref_max = float(np.abs(out.numpy() - ref).max()), float(np.abs(ref).max())
        errs[name] = (err, smoke.grad_tolerance("bfloat16", ref_max, n))
    return errs


def test_plan_at_the_chip_rows():
    """At the wide configurations' own shapes (N 64 and 16: one tile) the
    cluster splits dp's chunks 8 ways; at C 2048 (c_bar 256) one group of
    4 slices holds all of c_bar (dp computed once) and the 4 key tiles go
    one to a block; at the ragged N 1000 and at N 4096 the tiles are
    split (against one block an SM: ragged dkv's 96 blocks 4 ways) and each
    block keeps its own rows' chunks resident."""
    want = {
        ("dq", 4, 64, 64, 512): (1, 0, 1, 8, True, False),
        ("dkv", 4, 64, 64, 512): (1, 4, 3, 8, True, False),
        ("dq", 4, 16, 128, 1024): (2, 0, 1, 8, True, False),
        ("dkv", 4, 16, 128, 1024): (2, 4, 5, 8, True, False),
        ("dq", 2, 256, 256, 2048): (4, 0, 1, 4, False, False),
        ("dkv", 2, 256, 256, 2048): (4, 4, 9, 4, False, False),
        ("dq", 2, 1000, 64, 512): (1, 0, 1, 8, False, True),
        ("dkv", 2, 1000, 64, 512): (1, 4, 3, 4, False, True),
        ("dq", 4, 4096, 64, 512): (1, 0, 1, 1, False, True),
        ("dkv", 4, 4096, 64, 512): (1, 4, 3, 1, False, True),
    }
    for args, values in want.items():
        plan = plan_of(*args)
        assert tuple(plan[k] for k in ("subs", "dh_subs", "groups", "splits", "dsplit",
                                       "a_res")) == values, (args, plan)
    # Many batch rows at one tile fill the card without the split.
    assert plan_of("dq", 300, 64, 64, 512)["splits"] == 1
    assert [list(r) for r in _ranges(8, 8)] == [[k] for k in range(8)]
    assert [list(r) for r in _ranges(1, 8)][-1] == [0]  # one slice: the last block's


@pytest.mark.parametrize("n,c_bar,c", [(256, 128, 512), (64, 64, 512)],
                         ids=["tiles_split", "dp_split"])
def test_model_within_chip_tolerance(smoke, n, c_bar, c):
    """B 1 against the Pallas backward in interpret mode on the Pallas
    forward's lse and delta: N 256 (4 key tiles, one a block) at c_bar
    128, C 512, and N 64 (one tile; dp's 8 chunks one a block) at the
    512-channel config's widths."""
    b = 1
    f, g, h, do = _inputs(b, n, c_bar, c, seed=n + c_bar)
    plan = plan_of("dq", b, n, c_bar, c)
    assert plan["dsplit"] == (n == 64) and plan["splits"] == (8 if n == 64 else 4)
    jf, jg, jh, jdo = map(jnp.asarray, (f, g, h, do))
    o, lse = jattention._flash_forward(jf, jg, jh, 64, 64)
    delta = jnp.sum(jdo * o, axis=-1)
    refs = jattention._flash_backward(jf, jg, jh, jdo, lse, delta, 64, 64)
    errs = _errors(smoke, f, g, h, do, lse, delta, refs)
    assert all(0 < err <= limit for err, limit in errs.values()), errs


@pytest.mark.parametrize("n", [100, 200])
def test_model_at_ragged_n(smoke, n):
    """N 100 (two tiles, dp split, the last tile of 36 rows) and N 200
    (four tiles split over four blocks, the last of 8 rows) at c_bar 64, C
    512: against ``attention_core``'s gradient in fp32."""
    b, c_bar, c = 1, 64, 512
    f, g, h, do = _inputs(b, n, c_bar, c, seed=n)
    assert plan_of("dkv", b, n, c_bar, c)["dsplit"] == (n == 100)
    jf, jg, jh, jdo = map(jnp.asarray, (f, g, h, do))
    o = jattention.attention_core(jf, jg, jh)
    lse = jax.nn.logsumexp(jnp.einsum("bic,bjc->bij", jf, jg), axis=-1)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(jattention.attention_core(*a) * jdo),
                             argnums=(0, 1, 2)))(jf, jg, jh)
    errs = _errors(smoke, f, g, h, do, lse, jnp.sum(jdo * o, axis=-1), grads)
    assert all(0 < err <= limit for err, limit in errs.values()), errs


def _source(name: str) -> str:
    with open(os.path.join(cuda_build.CSRC_DIR, name)) as fh:
        return fh.read()


def test_bf16_wide_backward_runs_the_cluster_variant(smoke):
    """bf16 dq and dkv past c_bar 64 or C 256 report the cluster variant
    (flash_mma::Variant's kTensorCoreCluster, id 3), which the chip rows
    expect; the bf16 forward there stays on the tensor-core variant, and
    fp32 on the 3xTF32 one."""
    assert attention.VARIANT_IDS[3] == attention.TENSOR_CORE_CLUSTER
    assert "kTensorCoreCluster = 3" in _source("flash_mma.cuh")
    for c_bar, c in ((64, 512), (128, 1024), (256, 2048), (128, 64)):
        for kernel in (attention.DQ_KERNEL, attention.DKV_KERNEL):
            assert smoke.expected_variant(kernel, torch.bfloat16, c_bar, c) == \
                attention.TENSOR_CORE_CLUSTER
            assert smoke.expected_variant(kernel, torch.float32, c_bar, c) == attention.TF32X3
        assert smoke.expected_variant(attention.KERNEL_NAME, torch.bfloat16, c_bar, c) == \
            attention.TENSOR_CORE
    assert smoke.expected_variant(attention.DQ_KERNEL, torch.bfloat16, 64, 256) == \
        attention.TENSOR_CORE
    bwd = _source("flash_attn_bwd.cu")
    assert bwd.count("wide(cbar, c) ? flash_mma::kTensorCoreCluster : flash_mma::kTensorCore") == 2
    assert smoke.PEAK_FLOPS[attention.TENSOR_CORE_CLUSTER] == smoke.PEAK_FLOPS[
        attention.TENSOR_CORE]


def test_wide_bf16_kernel_source():
    """The bf16 dq and dkv body: bf16 mma.sync over ldmatrix'd chunks,
    five staging buffers, the group's slices in registers, P and ds packed
    to bf16 once a tile, dp's partial sums (each rank summing its share,
    then gathered) and the partial outputs added in rank order through
    distributed shared memory, the cluster shrunk where
    the card cannot hold it; only the forward instance of wide_mma_kernel
    is left, and nothing adds atomically."""
    src = _source("flash_wide.cuh")
    body = src[src.index("void bf16_group(Args<bf16> p"):src.index("struct Bf16Plan")]
    for op in ("mma_abt<true>(s, at, bt, warp, lane)", "if constexpr (DP) mma_abt<true>(dp, at, bt, warp, lane)",
               "mma_pv<true>(acc[i], pa, ring_b + (gs % S) * kChunkElems, lane)", "p_frags(pa, s)",
               "bf16_group<M, false, kBf16Subs>(", "bf16_group<M, true, SUBS>(",
               "cp_async_wait<S - 2>()", "peer_sources(srcs, xbuf, splits)",
               "peer(xsum, u * splits / kXUnits, splits)[u]",
               "peer_units(a, srcs, ((w * kBf16Subs + i) * 8 + jj) * 32 + ln, merge)",
               "cooperative_groups::this_cluster().sync()", "ex2("):
        assert op in body, op
    assert "constexpr int kBf16Stages = 5;" in src
    assert "cudaOccupancyMaxActiveClusters(" in src and "tile_splits(" in src
    assert set(re.findall(r"wide_mma_kernel<(\w+)>", src)) == {"kFwd"}
    assert 'static_assert(M == kFwd, "the bf16 dq and dkv run wide_bf16_kernel")' in src
    assert "atomicAdd" not in src and "torch/" not in src
    # One split rule and one cluster merge for the bf16 and the TF32 plans.
    assert src.count("inline int tile_splits(") == 1 and src.count("plan.splits = tile_splits(") == 2
    assert src.count("peer_units(a, srcs, ") == 3 and src.count("cluster_config(") == 3


def test_cpu_tensors_take_the_plain_versions():
    """bf16 at C 512, c_bar 64 on the CPU: the plain versions, exactly, and
    no launch counted."""
    f, g, h, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(1, 16, 64, 512, 5))
    attention.reset_launch_counts()
    o, lse = attention.flash_attention_forward(f, g, h)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    df = attention.flash_attention_dq(f, g, h, do, lse, delta)
    dg, dh = attention.flash_attention_dkv(f, g, h, do, lse, delta)
    torch.testing.assert_close(df, attention.flash_attention_dq_plain(f, g, h, do, lse, delta),
                               rtol=0, atol=0)
    plain = attention.flash_attention_dkv_plain(f, g, h, do, lse, delta)
    torch.testing.assert_close(dg, plain[0], rtol=0, atol=0)
    torch.testing.assert_close(dh, plain[1], rtol=0, atol=0)
    assert not any(attention.launch_counts.values())
    assert not any(attention.variant_counts.values())


def test_split_tool_cuts_match_the_sources():
    """Every text ``tools/flash_split.py`` cuts out of a copy of the
    sources (its tables of the register-held and the wide kernels, bf16 and
    fp32) is in the source it names: a cut that no longer matches fails
    only on the card."""
    spec = importlib.util.spec_from_file_location(
        "flash_split", os.path.join(REPO, "tools", "flash_split.py"))
    split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(split)
    tables = {**split.KERNELS, **split.WIDE_KERNELS}
    assert {key[:2] for key in split.WIDE_KERNELS if key[1] == "bfloat16"} == {
        (attention.DQ_KERNEL, "bfloat16"), (attention.DKV_KERNEL, "bfloat16")}
    for library, cuts, _ in tables.values():
        for name, lines in cuts.items():
            for cut in lines:
                file, old, _ = cut if len(cut) == 3 else (f"{library}.cu", *cut)
                assert old in _source(file), (library, name, old)
