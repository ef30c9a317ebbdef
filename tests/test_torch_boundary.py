"""The import boundary of the port: tenzing_tpu_torch and chip_smoke.py import
neither JAX nor any tenzing_tpu module, and the port's smoke driver leaves
JAX unloaded."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "tenzing_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "tenzing_tpu"), (path, mod)


def _reference_modules_after_smoke(request: str):
    """Run the port's smoke driver on ``DriverRequest(<request>)`` in a fresh
    interpreter; returns the jax/tenzing_tpu modules it loaded."""
    code = (
        "import sys, json\n"
        "from tenzing_tpu_torch.bench.driver import DriverRequest, run\n"
        f"r = run(DriverRequest({request}), device='cpu')\n"
        "assert r.verdict['metric'], r.verdict\n"
        "print(json.dumps(r.verdict))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tenzing_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


def test_smoke_driver_leaves_jax_unloaded():
    verdict, bad = _reference_modules_after_smoke(
        "smoke=True, mcts_iters=2, iters=3, search_iters=2")
    assert verdict["verified"] is True, verdict
    assert bad == []


def test_attn_smoke_driver_leaves_jax_unloaded():
    _, bad = _reference_modules_after_smoke(
        "smoke=True, workload='attn', mcts_iters=2, iters=3, search_iters=2")
    assert bad == []


def test_moe_smoke_driver_leaves_jax_unloaded():
    verdict, bad = _reference_modules_after_smoke(
        "smoke=True, workload='moe', mcts_iters=2, iters=3, search_iters=2")
    assert verdict["metric"] == "moe_pipe_pct50_searched_t32", verdict
    assert bad == []


def test_synth_and_learn_drivers_leave_jax_unloaded(tmp_path):
    """The spmv smoke with ``--synth-collectives`` (collectives/), then a
    halo smoke's database trained into a model (``--learn-train``) and a
    search screened by it (``--learn-screen``; learn/): neither jax nor
    tenzing_tpu is loaded where they run."""
    db, model = tmp_path / "h.csv", tmp_path / "m.json"
    code = (
        "import sys, json\n"
        "from tenzing_tpu_torch.bench.driver import DriverRequest, run\n"
        "small = dict(smoke=True, mcts_iters=4, iters=3, search_iters=2)\n"
        "r = run(DriverRequest(workload='spmv', synth_collectives=True,"
        " **small), device='cpu')\n"
        "assert r.verdict['perf']['synth']['menus'], r.verdict\n"
        f"run(DriverRequest(dump_csv={str(db)!r}, **small), device='cpu')\n"
        f"t = run(DriverRequest(smoke=True, learn_train=[{str(db)!r}],"
        f" learn_model={str(model)!r}), device='cpu')\n"
        "assert t.verdict['rows'] >= 4, t.verdict\n"
        f"s = run(DriverRequest(learn_screen=True, learn_model={str(model)!r},"
        " **small), device='cpu')\n"
        "assert s.verdict['learn']['escalations'] > 0, s.verdict\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tenzing_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_mesh_dryrun_leaves_jax_unloaded():
    """``python -m tenzing_tpu_torch.parallel.dryrun`` on the CPU: at one
    rank in the interpreter that runs it, at two ranks through the
    launcher; neither loads jax or tenzing_tpu where it runs."""
    code = (
        "import sys, json, io, contextlib\n"
        "from tenzing_tpu_torch.parallel import dryrun\n"
        "for n in ('1', '2'):\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        dryrun.main(['--nproc', n, '--device', 'cpu',\n"
        "                     '--mcts-iters', '2'])\n"
        "    s = json.loads(buf.getvalue().strip().splitlines()[-1])\n"
        "    assert s['n_ep'] == int(n) and s['backend'] == 'gloo', s\n"
        "    assert all(r['within_tol'] for r in s['schedules']), s\n"
        "    print(json.dumps(s))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tenzing_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_model_dryruns_leave_jax_unloaded():
    """Every other model's dryrun stage and the modeled stage on the CPU, at
    one rank in the interpreter that runs them and (the distributed SpMV,
    the ring, the synthesized TP MLP) at two ranks through the launcher: every schedule agrees, and
    neither jax nor tenzing_tpu is loaded where they run."""
    code = (
        "import sys, json, io, contextlib\n"
        "from tenzing_tpu_torch.parallel import dryrun\n"
        "runs = [(m, '1') for m in dryrun.MODELS + ('modeled',)]\n"
        "runs += [('spmv_dist', '2'), ('ring', '2'), ('tp_mlp_synth', '2')]\n"
        "for m, n in runs:\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        dryrun.main(['--model', m, '--nproc', n, '--device', 'cpu'])\n"
        "    s = json.loads(buf.getvalue().strip().splitlines()[-1])\n"
        "    assert s['dryrun'] == m, s\n"
        "    for st in s['stages']:\n"
        "        assert all(r['within_tol'] for r in st.get('schedules', [])),"
        " st\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tenzing_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_serve_query_and_daemon_drain_leave_jax_unloaded(tmp_path):
    """``python -m tenzing_tpu_torch.serve query`` (cold, then exact after the
    drain) and a ``--once`` daemon drain on the CPU, run as their modules'
    ``__main__`` in one interpreter (the drain in-process: the subprocess
    runner's child runs the same ``exec_item``): neither loads jax or
    tenzing_tpu."""
    store, queue = str(tmp_path / "s.json"), str(tmp_path / "q")
    query = ["query", "--store", store, "--queue", queue, "--platform",
             "cpu", "--workload", "spmv", "--smoke"]
    drain = ["--queue", queue, "--store", store, "--device", "cpu",
             "--in-process", "--once", "--override", "mcts_iters=4",
             "--override", "iters=3", "--override", "search_iters=2"]
    code = (
        "import sys, json, io, contextlib, runpy\n"
        "def main(mod, argv):\n"
        "    sys.argv = [mod] + argv\n"
        "    buf = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(buf):\n"
        "            runpy.run_module(mod, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert not e.code, e.code\n"
        "    return json.loads(buf.getvalue().strip().splitlines()[-1])\n"
        f"cold = main('tenzing_tpu_torch.serve', {query!r})\n"
        "assert cold['tier'] == 'cold', cold\n"
        f"s = main('tenzing_tpu_torch.serve.daemon', {drain!r})\n"
        "assert s['counters']['completed'] == 1, s\n"
        f"again = main('tenzing_tpu_torch.serve', {query!r})\n"
        "assert again['tier'] in ('exact', 'cold'), again\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tenzing_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_serve_listen_and_dr_leave_jax_unloaded(tmp_path):
    """A segmented store made by a cold query and a ``--once`` daemon drain
    on the CPU, then ``python -m tenzing_tpu_torch.serve listen --platform
    cpu`` over stdin (ping, the query twice, a batch, stats) and the
    store's ``compact``, ``backup`` and ``fsck``, all run as their modules'
    ``__main__`` in one interpreter: neither jax nor tenzing_tpu is loaded
    where they run."""
    store, queue = str(tmp_path / "st.d"), str(tmp_path / "q")
    query = ["query", "--store", store, "--queue", queue, "--platform",
             "cpu", "--workload", "spmv", "--smoke"]
    drain = ["--queue", queue, "--store", store, "--device", "cpu",
             "--in-process", "--once", "--override", "mcts_iters=4",
             "--override", "iters=3", "--override", "search_iters=2"]
    req = {"workload": "spmv", "smoke": True}
    lines = [{"op": "ping", "id": 0}, {"op": "query", "id": 1, "request": req},
             {"op": "query", "id": 2, "request": req},
             {"op": "batch", "id": 3, "requests": [req]},
             {"op": "stats", "id": 4}]
    stdin = "".join(json.dumps(x) + "\n" for x in lines)
    listen = ["listen", "--store", store, "--queue", queue, "--platform",
              "cpu", "--workers", "1", "--record", str(tmp_path / "rec")]
    code = (
        "import sys, json, io, contextlib, runpy\n"
        "def main(mod, argv, stdin=''):\n"
        "    sys.argv = [mod] + argv\n"
        "    sys.stdin = io.StringIO(stdin)\n"
        "    buf = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(buf):\n"
        "            runpy.run_module(mod, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert not e.code, e.code\n"
        "    return [json.loads(x) for x in buf.getvalue().splitlines()]\n"
        f"assert main('tenzing_tpu_torch.serve', {query!r})[-1]['tier'] =="
        " 'cold'\n"
        f"main('tenzing_tpu_torch.serve.daemon', {drain!r})\n"
        f"out = main('tenzing_tpu_torch.serve', {listen!r}, {stdin!r})\n"
        "by_id = {d.get('id'): d for d in out[:-1]}\n"
        "assert by_id[0]['pong'], by_id\n"
        "tiers = [by_id[i]['result']['tier'] for i in (1, 2)]\n"
        "assert tiers[0] == tiers[1] in ('exact', 'cold'), tiers\n"
        "assert by_id[3]['results'][0]['tier'] == tiers[0], by_id\n"
        "assert by_id[4]['stats']['store']['backend'] == 'segmented'\n"
        "assert out[-1]['reqlog']['records'] == 3, out[-1]\n"
        f"main('tenzing_tpu_torch.serve', ['compact', '--store', {store!r}])\n"
        f"main('tenzing_tpu_torch.serve', ['backup', '--store', {store!r}])\n"
        f"doc = main('tenzing_tpu_torch.serve', ['fsck', '--store', {store!r}"
        "])[-1]\n"
        "assert doc['rc'] == 0 and doc['backups'][0]['ok'], doc\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tenzing_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_obs_tools_and_replay_leave_jax_unloaded(tmp_path):
    """``python -m tenzing_tpu_torch.serve.replay --platform cpu`` on a tiny
    halo corpus (recording its traffic, keeping its stores), then
    ``obs.report`` over that corpus, the stores, the queue and a bundle
    with ``--check`` of the replay document against itself, ``obs.causal``
    and ``obs.export`` over the bundle and ``obs.alerts check`` on the
    segmented store and its queue, all run as their modules' ``__main__``
    in one interpreter: neither jax nor tenzing_tpu is loaded where they
    run."""
    src = REPO / "experiments" / "halo_search_tpu_r5a.csv"
    csv = tmp_path / "halo_tiny.csv"
    csv.write_text("".join(src.read_text().splitlines(True)[:25]))
    wd, out = str(tmp_path / "wd"), str(tmp_path / "replay.json")
    bundle = str(tmp_path / "bundle.jsonl")
    replay = ["--platform", "cpu", "--halo-csv", str(csv), "--spmv-csv",
              "--n", "16", "--qps", "400", "--noise-samples", "8",
              "--record", str(tmp_path / "rec"), "--workdir", wd,
              "--out", out]
    report = ["--csv", str(csv), "--store", wd + "/seg", wd + "/mono.json",
              "--queue-dir", wd + "/q-seg", "--causal", bundle,
              "--check", out, "--baseline", out,
              "--out", str(tmp_path / "report.md")]
    alerts = ["check", "--store", wd + "/seg", "--queue-dir", wd + "/q-seg",
              "--state", str(tmp_path / "alerts.json")]
    code = (
        "import sys, json, io, contextlib, runpy\n"
        "def main(mod, argv, ok=(0,)):\n"
        "    sys.argv = [mod] + argv\n"
        "    buf = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(buf):\n"
        "            runpy.run_module(mod, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert (e.code or 0) in ok, (mod, e.code)\n"
        "    return buf.getvalue()\n"
        "from tenzing_tpu_torch.obs import context\n"
        "from tenzing_tpu_torch.obs.export import write_jsonl\n"
        "from tenzing_tpu_torch.obs.tracer import Tracer\n"
        "tr = Tracer(enabled=True)\n"
        "with context.use(context.new_trace()):\n"
        "    with tr.span('serve.query', tier='exact'):\n"
        "        pass\n"
        f"write_jsonl(tr, {bundle!r})\n"
        f"line = json.loads(main('tenzing_tpu_torch.serve.replay', {replay!r})"
        ".splitlines()[-1])\n"
        "assert line['platform'] == 'cpu', line\n"
        f"main('tenzing_tpu_torch.obs.report', {report!r})\n"
        f"text = open({str(tmp_path / 'report.md')!r}).read()\n"
        "assert '**verdict: ok**' in text and '## Causal analysis' in text\n"
        f"main('tenzing_tpu_torch.obs.causal', [{bundle!r}])\n"
        f"main('tenzing_tpu_torch.obs.export', [{bundle!r}])\n"
        f"main('tenzing_tpu_torch.obs.alerts', {alerts!r}, ok=(0, 1))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tenzing_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_fleet_supervisor_and_fschaos_leave_jax_unloaded(tmp_path):
    """``python -m tenzing_tpu_torch.serve.fleet`` with stub members,
    ``serve.supervisor`` with a crash-loop ``--member-argv`` and
    ``fault.fschaos --skip-fleet``, all on the CPU and run as their modules'
    ``__main__`` in one interpreter: neither jax nor tenzing_tpu is loaded
    where they run, and the supervisor initializes no CUDA."""
    queue = str(tmp_path / "q")
    code = (
        "import sys, json, io, contextlib, runpy\n"
        "def main(mod, argv, ok=(0,)):\n"
        "    sys.argv = [mod] + argv\n"
        "    buf = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(buf):\n"
        "            runpy.run_module(mod, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert (e.code or 0) in ok, (mod, e.code)\n"
        "    return json.loads(buf.getvalue().strip().splitlines()[-1])\n"
        "from tenzing_tpu_torch.bench.driver import DriverRequest\n"
        "from tenzing_tpu_torch.serve.fingerprint import fingerprint_of\n"
        "from tenzing_tpu_torch.serve.store import WorkQueue\n"
        f"q = WorkQueue({queue!r})\n"
        "for m in (512, 712):\n"
        "    r = DriverRequest(workload='spmv', m=m)\n"
        "    q.enqueue(fingerprint_of(r, platform='cpu'), r.to_json(),"
        " reason='cold')\n"
        f"f = main('tenzing_tpu_torch.serve.fleet', ['--queue', {queue!r},"
        f" '--store', {str(tmp_path / 's.json')!r}, '--device', 'cpu',"
        " '--n', '2', '--stub-drain-secs', '0.05', '--idle-exit', '0.25',"
        " '--poll', '0.05'])\n"
        "assert f['drained'] == 2 and f['double_runs'] == {}, f\n"
        f"s = main('tenzing_tpu_torch.serve.supervisor', ['--queue',"
        f" {str(tmp_path / 'sq')!r}, '--store', {str(tmp_path / 'ss')!r},"
        " '--device', 'cpu', '--tick', '0.05', '--backoff-base', '0.05',"
        " '--backoff-max', '0.1', '--breaker-max-restarts', '2',"
        " '--compact-interval', '0', '--gc-interval', '0', '--drain-exit',"
        " '--member-argv', json.dumps([sys.executable, '-c',"
        " 'import sys; sys.exit(3)'])], ok=(1,))\n"
        "assert s['breakers']['fleet-0']['state'] == 'open', s\n"
        "assert s['cuda_initialized'] is False, s\n"
        f"v = main('tenzing_tpu_torch.fault.fschaos', ['--workdir',"
        f" {str(tmp_path / 'fc')!r}, '--skip-fleet', '--device', 'cpu'])\n"
        "assert v['ok'], v\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tenzing_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TENZING_FSINJECT", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


class _OwnerBench:
    """Deterministic answers for the owner's side of a fleet."""

    def benchmark(self, order, opts=None):
        from tenzing_tpu_torch.bench.benchmarker import BenchResult

        return BenchResult.from_times([1e-3 + 1e-6 * len(order)] * 3)

    def benchmark_batch_times(self, orders, opts=None, seed=0,
                              group_seeds=None):
        return [[1e-3 + 1e-6 * len(o)] * opts.n_iters for o in orders]


def test_fleet_worker_and_native_enumeration_leave_jax_unloaded(tmp_path):
    """A fleet worker (``search.fleet.worker_main``, served by an owner in
    this process) and a DFS enumeration through the native core, each in a
    fresh interpreter: neither loads jax or tenzing_tpu, and the worker
    initializes no CUDA."""
    import time

    from tenzing_tpu_torch.bench.benchmarker import BenchOpts
    from tenzing_tpu_torch.bench.driver import DriverRequest, graph_for
    from tenzing_tpu_torch.search.fleet import (
        FleetJob,
        MeasureOwner,
        _opts_to_json,
    )
    from tenzing_tpu_torch.utils.atomic import atomic_dump_json

    req = DriverRequest(workload="spmv", smoke=True)
    g, _ = graph_for(req)
    d = str(tmp_path / "fleet")
    for sub in ("jobs", "mq", "ctrl"):
        os.makedirs(os.path.join(d, sub))
    atomic_dump_json(os.path.join(d, "spec.json"), {
        "request": req.to_json(),
        "bench_opts": _opts_to_json(BenchOpts(n_iters=3, max_retries=1)),
        "n_workers": 1, "measure_batch": 2, "lease_ttl": 5.0,
        "verify": True})
    atomic_dump_json(os.path.join(d, "jobs", "job-0.json"),
                     FleetJob(index=0, budget=2, seed=2).to_json())
    owner = MeasureOwner(d, g, _OwnerBench(), measure_batch=2)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    bad_of = ("bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'tenzing_tpu'))\n"
              "print(json.dumps(bad))\n")
    worker = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, json, torch\n"
         "from tenzing_tpu_torch.search.fleet import worker_main\n"
         f"assert worker_main({d!r}, 0) == 0\n"
         "assert not torch.cuda.is_initialized()\n" + bad_of],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    deadline = time.time() + 120
    while worker.poll() is None and time.time() < deadline:
        owner.heartbeat()
        owner.drain(busy_workers=1)
        time.sleep(0.005)
    out, err = worker.communicate(timeout=5)
    assert worker.returncode == 0, err[-2000:]
    assert json.loads(out.strip().splitlines()[-1]) == []
    with open(os.path.join(d, "jobs", "job-0.done.json")) as f:
        done = json.load(f)
    assert "failed" not in done and done["sims"], done
    assert done["cuda_initialized"] is False
    enum = subprocess.run(
        [sys.executable, "-c",
         "import sys, json\n"
         "from tenzing_tpu_torch.core.graph import Graph\n"
         "from tenzing_tpu_torch.core.platform import Platform\n"
         "from tenzing_tpu_torch.models.spmv import SpMVCompound\n"
         "from tenzing_tpu_torch.native import bridge\n"
         "from tenzing_tpu_torch.solve.dfs import enumerate_schedules\n"
         "g = Graph(); c = SpMVCompound(); g.start_then(c); "
         "g.then_finish(c)\n"
         "assert bridge.native_available()\n"
         "assert len(enumerate_schedules(g, Platform.make_n_lanes(2), 50,"
         " log=lambda m: None)) == 50\n" + bad_of],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert enum.returncode == 0, enum.stderr[-2000:]
    assert json.loads(enum.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_port_file_names_the_reference_native_build(path):
    """The port builds its own native library: no file of it names the JAX
    package's library or the make rules that write it."""
    text = path.read_text()
    assert "_tznative" not in text and "Makefile" not in text, path
