"""The port's CUDA kernels against their plain PyTorch versions, on the
card, each launched through its operator (``torch.ops.corro.*``). Marked
``cuda``: they skip where no CUDA device is present and run on the card
with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(chip_smoke.py runs the same comparisons at the main paths' full shapes).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from corrosion_tpu_torch import cuda_build
from corrosion_tpu_torch.ops import onehot

pytestmark = pytest.mark.cuda

# Shared memory one block may use on Hopper (227 KB): the operators refuse
# row accumulators past it (csrc/ops.cpp kSmemLimit).
SMEM_LIMIT = 232_448


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, r, m, w, dev):
    g = np.random.default_rng(seed)
    idx = torch.as_tensor(g.integers(-3, w + 3, (r, m)), device=dev)
    val = torch.as_tensor(
        g.integers(0, 1 << 32, (r, m), dtype=np.uint64).astype(np.int64), device=dev
    )
    mask = torch.as_tensor(g.random((r, m)) < 0.7, device=dev)
    return idx, val, mask


# The last two widths take the shared-memory opt-in branch of every row
# kernel (rowmax/rowsum above 12,288 columns, delivery_reduce above 6,144).
SHAPES = [
    (1, 1, 1), (33, 17, 129), (300, 144, 512), (4, 64, 3000), (6, 144, 10_000),
    (3, 50, 16_384),
]


@pytest.mark.parametrize("r,m,w", SHAPES)
def test_kernels_equal_plain(cuda, r, m, w):
    idx, val, mask = _inputs(r + m + w, r, m, w, cuda)
    onehot.reset_launches()
    assert torch.equal(
        onehot.rowmax(idx, val, mask, w), onehot.rowmax_plain(idx, val, mask, w)
    )
    table = val[:, :1].expand(r, w).contiguous() ^ torch.arange(w, device=cuda)
    assert torch.equal(onehot.rowgather(table, idx), onehot.rowgather_plain(table, idx))
    seen = table & 0xFFFF
    d = val & 0xFF
    applied = mask & (d < 100)
    for got, want in zip(
        onehot.delivery_reduce(idx, d, val, applied, mask, seen, w),
        onehot.delivery_reduce_plain(idx, d, val, applied, mask, seen, w),
    ):
        assert torch.equal(got, want)
    for wk in (32, 64):
        oo = (table[None] * 2654435761 & 0xFFFFFFFF).expand(wk // 32, r, w).contiguous()
        adv_m = (val >> 8) & 0x3F
        for got, want in zip(
            onehot.window_delivery(oo, idx, d, adv_m, mask, wk, w),
            onehot.window_delivery_plain(oo, idx, d, adv_m, mask, wk, w),
        ):
            assert torch.equal(got, want)
    assert torch.equal(
        onehot.rowsum(idx, val, mask, w), onehot.rowsum_plain(idx, val, mask, w)
    )
    assert torch.equal(
        onehot.rowgather_wide(table, idx), onehot.rowgather_wide_plain(table, idx)
    )
    assert torch.equal(
        onehot.table_gather(val[0], idx), onehot.table_gather_plain(val[0], idx)
    )
    torch.cuda.synchronize()
    assert onehot.LAUNCHES == {
        "rowmax": 1, "rowgather": 1, "delivery_reduce": 1, "window_delivery": 2,
        "rowgather_wide": 1, "rowsum": 1, "table_gather": 1,
    }


# The row gathers in each form and both semantics: odd m (a scalar tail
# on every other row of the pairs form), odd W, row counts that are not a
# multiple of either form's tile (scalar: 256 outputs; pairs: 512), m at
# the form rule's threshold (W/2) and one either side, and wide rows
# (10,000 and 16,384 columns).
GATHER_SHAPES = [
    (1, 1, 1), (37, 19, 41), (33, 17, 130), (1001, 144, 512), (2001, 36, 256),
    (40, 128, 511), (40, 255, 512), (40, 256, 512), (40, 257, 512),
    (9, 144, 10_000), (3, 50, 16_384),
]


def _gather_cases(seed, r, m, w, dev):
    """(table, idx views): the plain [R, M] index with entries below 0 and
    at or above W, the same at an odd storage offset (not 16-byte
    aligned), and its first row broadcast as [1, M] and as a stride-0
    expand."""
    g = np.random.default_rng(seed)
    table = torch.as_tensor(
        g.integers(0, 1 << 32, (r, w), dtype=np.uint64).astype(np.int64), device=dev
    )
    flat = torch.as_tensor(g.integers(-3, w + 3, r * m + 1), device=dev)
    idx = flat[:-1].view(r, m)
    return table, (idx, flat[1:].view(r, m), idx[:1], idx[:1].expand(r, m))


@pytest.mark.parametrize("r,m,w", GATHER_SHAPES)
@pytest.mark.parametrize("form", [None, "scalar", "pairs"])
def test_row_gathers_equal_plain(cuda, r, m, w, form):
    # form None goes through the public wrappers (the rule picks); a named
    # form is forced through the wrappers' shared launcher.
    table, views = _gather_cases(r * m + w, r, m, w, cuda)
    onehot.reset_launches()
    for ix in views:
        want = onehot.rowgather_plain(table, ix)
        got = (onehot.rowgather(table, ix) if form is None
               else onehot._gather("rowgather", table, ix, False, form))
        assert torch.equal(got, want), ix.stride()
    for ix in views[:2]:
        want = onehot.rowgather_wide_plain(table, ix)
        got = (onehot.rowgather_wide(table, ix) if form is None
               else onehot._gather("rowgather_wide", table, ix, True, form))
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert onehot.LAUNCHES["rowgather"] == 4 and onehot.LAUNCHES["rowgather_wide"] == 2


# W from 1 to 100,000 (a table served from L2), W not a multiple of 128;
# 1-D to 3-D indices.
@pytest.mark.parametrize(
    "w,shape", [(1, (5,)), (300, (7, 9)), (2048, (16_667, 512)), (16_384, (3, 50, 20)),
                (100_000, (1000, 64))],
)
def test_table_gather_equals_plain(cuda, w, shape):
    g = np.random.default_rng(w)
    table = torch.as_tensor(
        g.integers(0, 1 << 32, w, dtype=np.uint64).astype(np.int64), device=cuda
    )
    idx = torch.as_tensor(g.integers(-w - 3, 2 * w + 3, shape), device=cuda)
    onehot.reset_launches()
    assert torch.equal(onehot.table_gather(table, idx), onehot.table_gather_plain(table, idx))
    torch.cuda.synchronize()
    assert onehot.LAUNCHES["table_gather"] == 1


# A block of the kernel covers 1,024 outputs as 16-byte pairs: n from 0 to
# 3, one block either side and several blocks and one (the scalar tail),
# each with the index at an aligned and at an odd storage offset (scalar
# index loads), at the widths of a tiny, the main paths' and a wide table.
@pytest.mark.parametrize("w", [1, 2048, 100_000])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 1023, 1024, 1025, 5 * 1024 + 1])
def test_table_gather_heads_tails_and_offsets(cuda, w, n):
    g = np.random.default_rng(n * 7 + w)
    table = torch.as_tensor(
        g.integers(0, 1 << 32, w, dtype=np.uint64).astype(np.int64), device=cuda
    )
    base = torch.as_tensor(g.integers(-w - 3, 2 * w + 3, n + 1), device=cuda)
    onehot.reset_launches()
    for idx in (base[:n], base[1:]):
        assert torch.equal(onehot.table_gather(table, idx), onehot.table_gather_plain(table, idx))
    torch.cuda.synchronize()
    assert onehot.LAUNCHES["table_gather"] == (2 if n else 0)


# The adaptive plane's sites: the intake priority ([512] <- [100000, 144])
# and the saturation test ([512] <- [100000, 48]) at wan_100k, the same at
# the geo scenario's 16 writers. A 2-D index aligned and at an odd storage
# offset gathers; a non-contiguous one is refused before any launch, and
# its contiguous copy gathers.
@pytest.mark.parametrize("w,r,m", [(512, 100_000, 144), (512, 100_000, 48), (16, 10_000, 64)])
def test_table_gather_adaptive_sites(cuda, w, r, m):
    g = np.random.default_rng(r + m)
    table = torch.as_tensor(g.integers(0, 1 << 32, w, dtype=np.uint64).astype(np.int64), device=cuda)
    flat = torch.as_tensor(g.integers(-3, w + 3, 2 * r * m + 1), device=cuda)
    onehot.reset_launches()
    for idx in (flat[: r * m].view(r, m), flat[1 : r * m + 1].view(r, m)):
        assert torch.equal(onehot.table_gather(table, idx), onehot.table_gather_plain(table, idx))
    strided = flat[: 2 * r * m].view(r, 2 * m)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        onehot.table_gather(table, strided)
    assert torch.equal(
        onehot.table_gather(table, strided.contiguous()), onehot.table_gather_plain(table, strided)
    )
    torch.cuda.synchronize()
    assert onehot.LAUNCHES["table_gather"] == 3


# The wrapper launches gather_form's form where none is forced: pairs
# from M = W/2 up, scalar below it and for a broadcast index (the kernel's
# template names its form: rowgather_kernel<clip, form>).
@pytest.mark.parametrize("m,broadcast", [(255, False), (256, False), (300, True)])
def test_rowgather_launches_the_rule_s_form(cuda, m, broadcast):
    from torch.profiler import ProfilerActivity, profile

    g = np.random.default_rng(m)
    table = torch.as_tensor(g.integers(0, 1 << 32, (64, 512)), device=cuda)
    idx = torch.as_tensor(g.integers(0, 512, (1 if broadcast else 64, m)), device=cuda)
    onehot.rowgather(table, idx)  # loads the library before the session
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        onehot.rowgather(table, idx)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "rowgather_kernel" in e.key]
    form = onehot.GATHER_FORMS.index(onehot.gather_form(512, m, broadcast))
    assert names and all(f"rowgather_kernel<false, {form}>" in n for n in names), names


def test_wrappers_refuse_wrong_inputs(cuda):
    idx, val, mask = _inputs(0, 8, 9, 10, cuda)
    with pytest.raises(TypeError):
        onehot.rowmax(idx.to(torch.int32), val, mask, 10)
    with pytest.raises(ValueError):
        onehot.rowmax(idx, val[:, ::2].contiguous(), mask, 10)
    with pytest.raises(ValueError):
        onehot.rowmax(idx, val.cpu(), mask, 10)
    with pytest.raises(ValueError, match="shared memory"):
        onehot.rowsum(idx, val, mask, SMEM_LIMIT // 4 + 1)
    with pytest.raises(ValueError):
        onehot.rowgather_wide(val, idx[:, :1].expand(8, 9))
    with pytest.raises(ValueError, match="form"):
        onehot._gather("rowgather", val, idx, False, "tiled")
    with pytest.raises(ValueError):
        onehot.table_gather(val, idx)
    with pytest.raises(ValueError):
        onehot.table_gather(val[0], idx[:, ::2])


# 227 KB of shared memory a block: rowmax/rowsum hold 4 B a column,
# delivery_reduce 8 B. W = 16,384 fits both; one column past the limit
# raises before any launch.
def test_row_kernels_refuse_rows_past_the_shared_memory_limit(cuda):
    idx, val, mask = _inputs(1, 2, 3, 16_384, cuda)
    onehot.reset_launches()
    for w in (16_384, SMEM_LIMIT // 8 + 1):
        seen = torch.zeros((2, w), dtype=torch.int64, device=cuda)
        if w == 16_384:
            onehot.rowsum(idx, val, mask, w)
            onehot.delivery_reduce(idx, val, val, mask, mask, seen, w)
            torch.cuda.synchronize()
            continue
        with pytest.raises(ValueError, match="shared memory"):
            onehot.delivery_reduce(idx, val, val, mask, mask, seen, w)
    with pytest.raises(ValueError, match="shared memory"):
        onehot.rowsum(idx, val, mask, SMEM_LIMIT // 4 + 1)
    assert onehot.LAUNCHES["rowsum"] == 1 and onehot.LAUNCHES["delivery_reduce"] == 1


def test_a_library_that_fails_to_build_raises_and_never_falls_back(cuda, tmp_path):
    # A fresh interpreter (this one has the library loaded), pointed at a
    # copy of csrc/ with one broken kernel: the CUDA call raises with the
    # compiler's output, launches nothing and returns no plain result.
    broken = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, broken)
    (broken / "table_gather.cu").write_text("this is not CUDA\n")
    code = (
        "from pathlib import Path\n"
        "import torch\n"
        "from corrosion_tpu_torch import cuda_build\n"
        f"cuda_build.CSRC = Path({str(broken)!r})\n"
        f"cuda_build.BUILD_DIR = Path({str(tmp_path / 'build')!r})\n"
        "from corrosion_tpu_torch.ops import onehot\n"
        "table = torch.arange(8, device='cuda')\n"
        "idx = torch.tensor([1, 9, -2], device='cuda')\n"
        "for _ in range(2):\n"
        "    try:\n"
        "        out = onehot.table_gather(table, idx)\n"
        "    except RuntimeError as e:\n"
        "        assert 'table_gather.cu' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit(f'no error: {out}')\n"
        "assert onehot.LAUNCHES['table_gather'] == 0 and not onehot._OPS\n"
        "assert not list((Path(cuda_build.BUILD_DIR)).glob('*.so'))\n"
        "print('raised')\n"
    )
    repo = Path(__file__).resolve().parent.parent
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(repo)),
    )
    assert res.returncode == 0 and res.stdout.strip() == "raised", res.stdout + res.stderr


# The chunk plane and the mixed engine at test size: the card (kernels) run
# equals the CPU (plain versions) run, curve for curve and leaf for leaf;
# the chunk plane launches nothing, the mixed storm its fast path's kernels.
def test_chunk_and_mixed_runs_equal_the_cpu_runs(cuda):
    from corrosion_tpu_torch import interop
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import chunk_engine, mixed_engine

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
        return {prefix: tree}

    def chunk_run(dev):
        cfg, origin, last, _ = baselines.anti_entropy_chunks(n=48, streams=4, last_seq=1023,
                                                             device=dev)
        state, m = chunk_engine.simulate_chunks(cfg, origin, last, 40, seed=1, device=dev)
        return flat({"state": interop.to_numpy(state), "curves": m["curves"],
                     "vis": m["vis"].cpu().numpy()})

    def mixed_run(dev):
        built = baselines.mixed_storm(n=64, streams=2, last_seq=255, rounds=24, samples=16,
                                      device=dev)
        final, curves = mixed_engine.simulate_mixed(*built, seed=0, device=dev)
        return flat({"state": interop.to_numpy(final), "curves": curves})

    for run, kernels in ((chunk_run, ()), (mixed_run, ("rowmax", "rowgather", "delivery_reduce"))):
        onehot.reset_launches()
        card = run("cuda")
        torch.cuda.synchronize()
        launched = {k for k, v in onehot.LAUNCHES.items() if v}
        assert launched >= set(kernels) if kernels else not launched, launched
        want = run("cpu")
        assert card.keys() == want.keys()
        bad = [k for k in card if not np.array_equal(card[k], want[k])]
        assert not bad, bad


# The curve consumers at test size: the card's demo flight is the CPU's
# line for line (bar the wall clock), and the invariant suite's dense and
# sparse reports on the card equal the CPU's.
def test_demo_flight_and_invariant_reports_equal_the_cpu(cuda, tmp_path):
    import json

    from corrosion_tpu_torch.sim import faults, health, invariants

    def lines(path):
        out = []
        for line in open(path):
            rec = json.loads(line)
            rec.pop("t_unix", None)
            rec.pop("wall_s", None)
            out.append(rec)
        return out

    kw = dict(nodes=96, rounds=48, churn=True, seed=0, geo=True, adaptive=True)
    onehot.reset_launches()
    card = health.record_demo_flight(str(tmp_path / "card.jsonl"), **kw, device="cuda")
    assert onehot.LAUNCHES["table_gather"] > 0 and onehot.LAUNCHES["window_delivery"] > 0
    cpu = health.record_demo_flight(str(tmp_path / "cpu.jsonl"), **kw, device="cpu")
    assert {k: v for k, v in card.items() if k != "flight"} == \
           {k: v for k, v in cpu.items() if k != "flight"}
    assert lines(tmp_path / "card.jsonl") == lines(tmp_path / "cpu.jsonl")
    plan = faults.named_scenarios(24, 4, 48, protect=invariants.PROTECTED)["kitchen-sink"]
    for eng in ("dense", "sparse"):
        a = invariants.RUNNERS[eng](plan, seed=0, device="cuda").to_dict()
        assert a == invariants.RUNNERS[eng](plan, seed=0, device="cpu").to_dict(), eng
