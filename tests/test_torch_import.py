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


def _run(code: str, **names) -> subprocess.CompletedProcess:
    """Run ``code`` in a fresh interpreter, with each of ``names`` bound
    to its value's ``repr`` first."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    code = "".join(f"{k} = {v!r}\n" for k, v in names.items()) + code
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
        "assert len(names) >= 100, len(names)\n"
        "assert {'corrosion_tpu_torch.obs.epidemic', 'corrosion_tpu_torch.sim.invariants',\n"
        "        'corrosion_tpu_torch.sim.checkpoint', 'corrosion_tpu_torch.sim.trace',\n"
        "        'corrosion_tpu_torch.parallel', 'corrosion_tpu_torch.parallel.mesh',\n"
        "        'corrosion_tpu_torch.parallel.shard_driver', 'corrosion_tpu_torch.elastic',\n"
        "        'corrosion_tpu_torch.elastic.report', 'corrosion_tpu_torch.elastic.reshard',\n"
        "        'corrosion_tpu_torch.elastic.preempt',\n"
        "        'corrosion_tpu_torch.elastic.scenarios', 'corrosion_tpu_torch.sim.benchlib',\n"
        "        'corrosion_tpu_torch.obs.ledger', 'corrosion_tpu_torch.obs.costs'} <= set(names)\n"
        "want = set(HOST_PLANES) | set(SERVING) | set(CHAOS_FIDELITY)\n"
        "assert want <= set(names), want - set(names)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'corrosion_tpu' or m.startswith('corrosion_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(names))\n",
        HOST_PLANES=HOST_PLANES, SERVING=SERVING, CHAOS_FIDELITY=CHAOS_FIDELITY,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")


# The host planes: modules that import no torch, some of them only inside
# functions (the soak drill's runner, ``record_process_sample``).
HOST_PLANES = (
    "corrosion_tpu_torch.native", "corrosion_tpu_torch.core", "corrosion_tpu_torch.core.values",
    "corrosion_tpu_torch.core.ids", "corrosion_tpu_torch.core.hlc",
    "corrosion_tpu_torch.core.changes", "corrosion_tpu_torch.core.intervals",
    "corrosion_tpu_torch.core.bookkeeping", "corrosion_tpu_torch.utils",
    "corrosion_tpu_torch.utils.metrics", "corrosion_tpu_torch.utils.tracing",
    "corrosion_tpu_torch.utils.backoff", "corrosion_tpu_torch.utils.spawn",
    "corrosion_tpu_torch.utils.tripwire", "corrosion_tpu_torch.utils.locks",
    "corrosion_tpu_torch.utils.logfmt", "corrosion_tpu_torch.obs.series",
    "corrosion_tpu_torch.obs.endurance", "corrosion_tpu_torch.sim.host_oracles",
    "corrosion_tpu_torch.obs", "corrosion_tpu_torch.obs.trajectory",
    "corrosion_tpu_torch.obs.serving", "corrosion_tpu_torch.obs.timeline",
    "corrosion_tpu_torch.obs.journey", "corrosion_tpu_torch.agent",
    "corrosion_tpu_torch.agent.membership", "corrosion_tpu_torch.agent.config",
    "corrosion_tpu_torch.agent.pgsql", "corrosion_tpu_torch.agent.store",
    "corrosion_tpu_torch.agent.transport", "corrosion_tpu_torch.client",
    "corrosion_tpu_torch.agent.pool", "corrosion_tpu_torch.agent.subs",
    "corrosion_tpu_torch.agent.backup", "corrosion_tpu_torch.agent.netem",
    "corrosion_tpu_torch.agent.agent", "corrosion_tpu_torch.agent.api",
    "corrosion_tpu_torch.agent.admin", "corrosion_tpu_torch.agent.testing",
)
# The serving plane: the PG wire server, gossip TLS (it needs the
# ``cryptography`` package, so the agent imports it only where a config
# asks for TLS), the Consul bridge, templates and the load generator.
SERVING = (
    "corrosion_tpu_torch.agent.pg", "corrosion_tpu_torch.agent.tls",
    "corrosion_tpu_torch.integrations", "corrosion_tpu_torch.integrations.consul",
    "corrosion_tpu_torch.tpl", "corrosion_tpu_torch.loadgen",
    "corrosion_tpu_torch.loadgen.schedule", "corrosion_tpu_torch.loadgen.oracle",
    "corrosion_tpu_torch.loadgen.pgread", "corrosion_tpu_torch.loadgen.harness",
    "corrosion_tpu_torch.loadgen.report", "corrosion_tpu_torch.loadgen.scenarios",
)
# The chaos and fidelity planes: host chaos against live agents, the
# calibrated round model and the live-versus-kernel comparison.
CHAOS_FIDELITY = (
    "corrosion_tpu_torch.hostchaos", "corrosion_tpu_torch.hostchaos.harness",
    "corrosion_tpu_torch.hostchaos.report", "corrosion_tpu_torch.hostchaos.scenarios",
    "corrosion_tpu_torch.fidelity", "corrosion_tpu_torch.fidelity.calibrate",
    "corrosion_tpu_torch.fidelity.compare", "corrosion_tpu_torch.fidelity.report",
    "corrosion_tpu_torch.fidelity.scenarios",
)


def test_lazy_imports_of_the_host_planes_stay_in_the_port():
    """Every import inside a function of the host planes (read from their
    source) names the port or the standard library, never JAX or the
    reference; and importing them compiles nothing: the native build
    waits for ``native.build()``."""
    import ast
    import importlib.util

    for name in HOST_PLANES + SERVING + CHAOS_FIDELITY + ("corrosion_tpu_torch.elastic.scenarios",):
        src = Path(importlib.util.find_spec(name).origin).read_text()
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            elif isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "corrosion_tpu"), (name, m)
    res = _run(
        "import subprocess, sys\n"
        "calls = []\n"
        "real = subprocess.run\n"
        "subprocess.run = lambda *a, **k: calls.append(a) or real(*a, **k)\n"
        "import importlib\n"
        "for n in HOST_PLANES: importlib.import_module(n)\n"
        "from corrosion_tpu_torch import native\n"
        "assert calls == [], calls\n"
        "assert callable(native.build) and native.BUILD_DIR.endswith('build/native')\n"
        "print('ok')\n",
        HOST_PLANES=HOST_PLANES,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_the_agent_builds_nothing_until_native_build():
    """Importing the agent (its store loads ``native`` and ``core/``) and
    opening a store compiles nothing and writes nothing under
    ``build/native``; the store's merge then is the extension only where
    an earlier ``native.build()`` left it there."""
    res = _run(
        "import os, subprocess, sys, tempfile\n"
        "calls = []\n"
        "real = subprocess.run\n"
        "subprocess.run = lambda *a, **k: calls.append(a) or real(*a, **k)\n"
        "from corrosion_tpu_torch import native\n"
        "before = sorted(os.listdir(native.BUILD_DIR)) if os.path.isdir(native.BUILD_DIR) else None\n"
        "import corrosion_tpu_torch.agent as agent\n"
        "from corrosion_tpu_torch.agent import transport\n"
        "d = tempfile.mkdtemp()\n"
        "s = agent.Store(os.path.join(d, 'a.db'), b'\\x01' * 16)\n"
        "assert s.native_crdt == native.crdt_ext_available()\n"
        "s.close()\n"
        "assert transport._native is native\n"
        "after = sorted(os.listdir(native.BUILD_DIR)) if os.path.isdir(native.BUILD_DIR) else None\n"
        "assert calls == [] and before == after, (calls, before, after)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'corrosion_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_raise_without_cuda():
    res = _run(
        "import os, torch\n"
        "assert not torch.cuda.is_available()\n"
        "from corrosion_tpu_torch.models import baselines\n"
        "from corrosion_tpu_torch.sim import chunk_engine, engine, health, invariants, mixed_engine\n"
        "from corrosion_tpu_torch.sim import faults\n"
        "from corrosion_tpu_torch import parallel\n"
        "from corrosion_tpu_torch.elastic import scenarios\n"
        "from corrosion_tpu_torch.sim import host_oracles\n"
        "from corrosion_tpu_torch.loadgen import report, scenarios as lscenarios\n"
        "import asyncio\n"
        "from corrosion_tpu_torch.fidelity import compare, report as freport, scenarios as fscen\n"
        "from corrosion_tpu_torch.hostchaos import report as hreport\n"
        "from corrosion_tpu_torch.sim.trace import Trace\n"
        "trace = Trace(events=[(0, 'aa', 1), (40, 'bb', 1)])\n"
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
        "             lambda: invariants.run_dense(plan),\n"
        "             lambda: parallel.make_mesh(2),\n"
        "             lambda: parallel.make_wan_mesh(2, 2),\n"
        "             lambda: scenarios.run_scenario('reshard_dense_4to8'),\n"
        "             lambda: host_oracles.window_bookie(),\n"
        "             lambda: host_oracles.store_crdt_trials(),\n"
        "             lambda: host_oracles.membership_rings(),\n"
        "             lambda: host_oracles.agent_cluster_live(),\n"
        "             lambda: lscenarios.intake_policy(nodes=8, rounds=2),\n"
        "             lambda: report.serving_context('fanout_storm', 1, 32),\n"
        "             lambda: compare.kernel_replay(trace, 500.0, n_nodes=4),\n"
        "             lambda: asyncio.run(compare.compare_live_kernel(os.devnull, [(0.0, 0)])),\n"
        "             lambda: asyncio.run(fscen.steady_load(os.devnull)),\n"
        "             lambda: asyncio.run(fscen.burst_drain(os.devnull)),\n"
        "             lambda: asyncio.run(fscen.full_report(os.devnull)),\n"
        "             lambda: fscen.dcn_partition(rounds=8),\n"
        "             lambda: freport.fidelity_context('steady', 3, 'ab12'),\n"
        "             lambda: hreport.hostchaos_context(3, 'wan_steady'),\n"
        "             lambda: host_oracles.fidelity_live('steady'),\n"
        "             lambda: host_oracles.fidelity_replay_10k(trace, nodes=4),\n"
        "             lambda: host_oracles.fidelity_dcn(),\n"
        "             lambda: host_oracles.hostchaos_pair()):\n"
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
        "mesh = parallel.make_wan_mesh(2, 2, device='cpu')\n"
        "placed, _ = parallel.simulate_sharded(cfg, topo, sched, mesh)\n"
        "assert all(b.device.type == 'cpu' for b in placed.data.contig.blocks)\n"
        "assert final.chunks.have.starts.device.type == 'cpu'\n"
        "rep = compare.kernel_replay(trace, 500.0, n_nodes=4, device='cpu')\n"
        "assert rep['unseen'] == 0 and rep['pairs'] == 6\n"
        "assert hreport.hostchaos_context(3, device='cpu')['platform'] == 'cpu'\n"
        "print('ok')\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_bench_and_cost_modules_need_no_cuda_and_no_triton():
    res = _run(
        "import sys, torch\n"
        "assert not torch.cuda.is_available()\n"
        "from corrosion_tpu_torch.sim import benchlib, telemetry\n"
        "from corrosion_tpu_torch.obs import costs, ledger\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'corrosion_tpu', 'triton'))\n"
        "assert not bad, bad\n"
        "assert telemetry.check_bench_invariants and telemetry.attribute_planes\n"
        "for call in (lambda: costs.cost_entry('chunk'),\n"
        "             lambda: costs.build_cost_model(engines=('chunk',)),\n"
        "             lambda: costs.capacity_model(node_counts=(4096,)),\n"
        "             lambda: benchlib.measure_multichip(device_counts=(1,))):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('ran without CUDA and without a device')\n"
        "print('ok')\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_the_agent_refuses_tls_without_the_reference():
    """The package, ``agent`` and the serving plane import without the
    ``cryptography`` package (``tls`` is imported only where a config asks
    for TLS); an ``Agent`` whose config sets ``AgentConfig.tls`` then
    raises the reference's own ``ModuleNotFoundError``, never a plaintext
    fallback. With ``cryptography``, the agent's gossip transport wraps
    the port's ``tls`` contexts, and nothing of JAX or the reference is
    loaded either way."""
    res = _run(
        "import os, sys, tempfile\n"
        "sys.modules['cryptography'] = None\n"
        "import corrosion_tpu_torch, corrosion_tpu_torch.agent\n"
        "from corrosion_tpu_torch.agent.agent import Agent, AgentConfig, AgentTls\n"
        "from corrosion_tpu_torch.agent import pg\n"
        "from corrosion_tpu_torch.loadgen import scenarios\n"
        "from corrosion_tpu_torch import tpl\n"
        "from corrosion_tpu_torch.integrations import consul\n"
        "assert 'corrosion_tpu_torch.agent.tls' not in sys.modules\n"
        "d = os.path.join(tempfile.mkdtemp(), 'agent')\n"
        "cfg = AgentConfig(data_dir=d, tls=AgentTls(cert='c.pem', key='k.pem'))\n"
        "try:\n"
        "    Agent(cfg)\n"
        "except ModuleNotFoundError as e:\n"
        "    assert e.name == 'cryptography', e\n"
        "else:\n"
        "    raise SystemExit('an agent with tls set was built without cryptography')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'corrosion_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    res = _run(
        "import asyncio, os, ssl, sys, tempfile\n"
        "from corrosion_tpu_torch.agent import tls\n"
        "from corrosion_tpu_torch.agent.agent import Agent, AgentConfig, AgentTls\n"
        "d = tempfile.mkdtemp()\n"
        "tls.generate_ca(os.path.join(d, 'ca'))\n"
        "srv = tls.generate_server_cert(os.path.join(d, 's'), os.path.join(d, 'ca'), '127.0.0.1')\n"
        "ca = os.path.join(d, 'ca', tls.CA_CERT)\n"
        "cfg = AgentConfig(data_dir=os.path.join(d, 'a'),\n"
        "                  tls=AgentTls(cert=srv.cert, key=srv.key, ca=ca, mtls=False))\n"
        "a = Agent(cfg)\n"
        "assert isinstance(a.transport._ssl_server, ssl.SSLContext)\n"
        "assert isinstance(a.transport._ssl_client, ssl.SSLContext)\n"
        "a.store.close()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'corrosion_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
