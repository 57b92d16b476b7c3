"""Import hygiene of the port: importing ``corrosion_tpu_torch`` and every
submodule pulls in neither JAX nor the reference package, and the entry
points refuse to run without CUDA unless the caller names a device.

Each check runs in a fresh interpreter so ``sys.modules`` starts clean
(pytest's own process has both packages loaded).
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_port_imports_no_jax_and_no_reference():
    res = _run(
        "import importlib, pkgutil, sys\n"
        "import corrosion_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 30, names\n"
        "assert {'corrosion_tpu_torch.obs.epidemic', 'corrosion_tpu_torch.sim.invariants',\n"
        "        'corrosion_tpu_torch.sim.checkpoint', 'corrosion_tpu_torch.sim.trace'} <= set(names)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'corrosion_tpu' or m.startswith('corrosion_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(names))\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")


def test_entry_points_raise_without_cuda():
    res = _run(
        "import os, torch\n"
        "assert not torch.cuda.is_available()\n"
        "from corrosion_tpu_torch.models import baselines\n"
        "from corrosion_tpu_torch.sim import chunk_engine, engine, health, invariants, mixed_engine\n"
        "from corrosion_tpu_torch.sim import faults\n"
        "plan = faults.named_scenarios(24, 4, 48)['loss-burst']\n"
        "kw = dict(n=40, n_regions=2, n_writers=4, rounds=4, samples=4)\n"
        "cfg, topo, sched = baselines.wan_100k(device='cpu', **kw)\n"
        "mkw = dict(n=64, streams=2, last_seq=63, rounds=4, samples=4)\n"
        "mixed = baselines.mixed_storm(device='cpu', **mkw)\n"
        "ccfg, origin, last, _ = baselines.anti_entropy_chunks(n=16, streams=2, device='cpu')\n"
        "for call in (lambda: engine.simulate(cfg, topo, sched),\n"
        "             lambda: engine.init_cluster(cfg, 4),\n"
        "             lambda: baselines.wan_100k(**kw),\n"
        "             lambda: chunk_engine.simulate_chunks(ccfg, origin, last, 2),\n"
        "             lambda: mixed_engine.simulate_mixed(*mixed),\n"
        "             lambda: baselines.mixed_storm(**mkw),\n"
        "             lambda: baselines.anti_entropy_chunks(n=16),\n"
        "             lambda: health.record_demo_flight(os.devnull, nodes=32, rounds=16),\n"
        "             lambda: invariants.run_dense(plan)):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e)\n"
        "    else:\n"
        "        raise SystemExit('ran without CUDA and without a device')\n"
        "final, curves = engine.simulate(cfg, topo, sched, device='cpu')\n"
        "assert final.data.contig.device.type == 'cpu'\n"
        "state, m = chunk_engine.simulate_chunks(ccfg, origin, last, 2, device='cpu')\n"
        "assert state.have.starts.device.type == m['vis'].device.type == 'cpu'\n"
        "final, curves = mixed_engine.simulate_mixed(*mixed, device='cpu')\n"
        "assert final.chunks.have.starts.device.type == 'cpu'\n"
        "print('ok')\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
