"""The port's counterparts of the JAX package's last three ``tools/`` entry
points, on the CPU.

* ``profile_infer`` (``tools/profile_infer.py``): a tiny MedFormer's trace
  prints its line with every key and a row for each of the model's
  children; the module rows and the time outside the model add up to the
  total; the traced call's probabilities equal ``sliding_window_inference``'s
  outside the profiler, bit for bit.
* ``train_forever`` (``tools/train_forever.sh``): an attempt that crashes
  after its first checkpoint is followed by one that resumes to the end; the
  final checkpoint equals an uninterrupted run's bit for bit.
* ``launch_llm_fleet`` (``tools/launch_llm_fleet.sh``): two workers against
  stub OpenAI endpoints on localhost (an ``http.server`` thread a port, in
  place of the vLLM servers) write the ``per_tumor.csv`` and ``per_ct.csv``
  of one ``--parts 1`` run of the port's ``report_extraction.run`` and of
  the JAX package's against the same stub; a worker that fails makes the
  launcher fail; the servers' command line is the script's.
"""

import json
import socket
import sys
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from rsuper_tpu.report_extraction import run as jrun
from rsuper_tpu_torch import launch_llm_fleet as fleet
from rsuper_tpu_torch import profile_infer, train_forever
from rsuper_tpu_torch.bench_train import CLASSES
from rsuper_tpu_torch.inference.sliding_window import sliding_window_inference
from rsuper_tpu_torch.models import get_model, init_params
from rsuper_tpu_torch.report_extraction import run as trun
from test_torch_loop import PRESET, TINY, _cli_args, _write_cases
from test_torch_loop import _one_intra_op_thread  # noqa: F401
from test_torch_report_extraction import ANSWERS, _reports

ROOT = Path(__file__).resolve().parent.parent
CHILDREN = ["Conv_0", "BasicBlock_0", "DownBlockMF_0", "DownBlockMF_1",
            "DownBlockMF_2", "DownBlockMF_3", "SemanticMapFusion_0",
            "UpBlockMF_0", "UpBlockMF_1", "aux_out", "UpBlockMF_2",
            "UpBlockMF_3", "outc"]
KEYS = {"card", "device_ms_total", "events", "top_ops", "modules",
        "outside_model_ms", "wall_ms"}


def test_profile_infer_prints_its_line_on_the_cpu(tmp_path, monkeypatch):
    traced = []
    real = profile_infer.trace_prediction

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        traced.append(out[0])
        return out

    monkeypatch.setattr(profile_infer, "trace_prediction", spy)
    line = profile_infer.main([
        "--device", "cpu", "--edge", "32", "--window", "16", "--batch", "2",
        "--model_args_json", json.dumps(TINY), "--out", str(tmp_path)])
    assert KEYS <= set(line) and line["card"] == "cpu"
    assert line["events"] > 0 and line["device_ms_total"] > 0
    assert line["wall_ms"] > 0
    assert all(set(op) == {"name", "ms", "count"} for op in line["top_ops"])
    assert "aten::mkldnn_convolution" in [op["name"] for op in
                                          line["top_ops"]]
    rows = {m["name"]: m["ms"] for m in line["modules"]}
    assert list(rows)[:len(CHILDREN)] == CHILDREN
    assert set(rows) == set(CHILDREN) | {"MedFormer (outside its children)"}
    assert all(ms > 0 for ms in rows.values())
    total = sum(rows.values()) + line["outside_model_ms"]
    assert abs(total - line["device_ms_total"]) <= 1e-6 * total
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert set(CHILDREN) <= names

    model = init_params(get_model("medformer", len(CLASSES), dict(TINY),
                                  dtype=torch.bfloat16), seed=0).eval()

    def fn(x):
        return model(x)["segmentation"][0]

    vol = np.random.default_rng(0).normal(size=(32,) * 3).astype(np.float32)
    want = sliding_window_inference(fn, vol, len(CLASSES), window=(16,) * 3,
                                    batch=2, device="cpu")
    assert len(traced) == 1 and traced[0].dtype == want.dtype
    assert np.array_equal(traced[0], want)


def _x(cat, name, ts, end, tid=1):
    return dict(ph="X", cat=cat, name=name, pid=0, tid=tid, ts=ts,
                dur=end - ts)


def test_profile_infer_attributes_by_the_range_holding_each_start():
    """``attribute`` on hand-made trace events: on a card, kernels by the
    device-side range holding their start (a child's, the model's outside
    its children, none); on the CPU, operators' own time (less their
    nested operators') by the CPU-side ranges."""
    g, k = "gpu_user_annotation", "kernel"
    events = [_x(g, "MedFormer", 0, 100), _x(g, "A", 10, 20),
              _x(g, "B", 30, 60), _x(g, "A", 70, 80),
              _x(k, "k1", 10, 15), _x(k, "k2", 15, 20), _x(k, "k1", 35, 55),
              _x(k, "k3", 25, 28), _x(k, "k1", 70, 71),
              _x("gpu_memcpy", "Memcpy DtoH", 120, 130),
              _x("user_annotation", "A", 0, 500), _x("cpu_op", "op", 0, 50),
              dict(ph="M", name="process_name", pid=0)]
    res = profile_infer.attribute(events, "MedFormer", ["A", "B"], True)
    rows = {m["name"]: m["ms"] for m in res["modules"]}
    assert rows == pytest.approx({"A": 11e-3, "B": 20e-3,
                                  "MedFormer (outside its children)": 3e-3})
    assert res["outside_model_ms"] == pytest.approx(10e-3)
    assert res["events"] == 6
    assert res["top_ops"][0] == dict(name="k1", ms=pytest.approx(26e-3),
                                     count=3)
    assert res["device_ms_total"] == pytest.approx(44e-3)

    u, c = "user_annotation", "cpu_op"
    events = [_x(u, "MedFormer", 0, 100), _x(u, "A", 5, 50),
              _x(c, "conv", 10, 40), _x(c, "mm", 12, 30), _x(c, "add", 30, 35),
              _x(c, "pad", 60, 70), _x(c, "copy", 150, 160),
              _x(c, "mm", 11, 19, tid=2), _x(k, "k1", 10, 15)]
    res = profile_infer.attribute(events, "MedFormer", ["A"], False)
    rows = {m["name"]: m["ms"] for m in res["modules"]}
    assert rows == pytest.approx({"A": 38e-3,
                                  "MedFormer (outside its children)": 10e-3})
    assert res["outside_model_ms"] == pytest.approx(10e-3)
    assert {o["name"]: o["ms"] for o in res["top_ops"]} == pytest.approx(
        {"conv": 7e-3, "mm": 26e-3, "add": 5e-3, "pad": 10e-3,
         "copy": 10e-3})


CRASH = """
import os, sys
sys.path.insert(0, {root!r})
from rsuper_tpu_torch.config import config
from rsuper_tpu_torch.train import checkpoint
config.DEFAULT_CONFIGS[{preset!r}].update(
    model_args={tiny!r}, training_size=(32, 32, 32), compute_dtype="float32")
marker = os.environ.get("CRASH_MARKER")
if marker and not os.path.exists(marker):
    save = checkpoint.CheckpointManager.save_epoch

    def crash(self, *args, **kwargs):
        save(self, *args, **kwargs)
        open(marker, "w").close()
        os._exit(3)

    checkpoint.CheckpointManager.save_epoch = crash
from rsuper_tpu_torch.train.__main__ import main
main(sys.argv[1:])
"""


def _same_payload(a, b, where="checkpoint"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            _same_payload(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_payload(x, y, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_train_forever_resumes_a_crashed_run_to_its_end(tmp_path, capsys,
                                                        monkeypatch):
    """The loop's attempts run the CLI in fresh interpreters, the first
    crashing once its first checkpoint is written; the uninterrupted run
    is the CLI's ``main`` in this process."""
    from rsuper_tpu_torch.config import config
    from rsuper_tpu_torch.train import __main__ as cli

    data = _write_cases(tmp_path / "cases")
    marker = tmp_path / "crash_marker"
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("CRASH_MARKER", str(marker))
    command = [sys.executable, "-c", CRASH.format(root=str(ROOT),
                                                  preset=PRESET, tiny=TINY)]
    short = ("--iter_per_epoch", "1", "--epochs", "2")
    monkeypatch.setenv("COOLDOWN", "0")
    assert train_forever.run(_cli_args(data, tmp_path / "crashed", *short),
                             command) == 0
    assert marker.exists()
    err = capsys.readouterr().err
    assert err.count("training exited with code 3; restarting in 0s") == 1
    log = (tmp_path / "crashed" / "test" / "train.log").read_text()
    assert "resumed from step 1" in log

    monkeypatch.setitem(config.DEFAULT_CONFIGS, PRESET, dict(
        config.DEFAULT_CONFIGS[PRESET], model_args=TINY,
        training_size=(32, 32, 32), compute_dtype="float32"))
    assert cli.main(_cli_args(data, tmp_path / "whole", *short)).step == 2
    runs = {name: torch.load(tmp_path / name / "test" / "latest",
                             weights_only=True)
            for name in ("whole", "crashed")}
    assert runs["whole"]["step"] == 2
    _same_payload(runs["whole"], runs["crashed"])


def test_train_forever_reads_its_cooldown(monkeypatch):
    calls, sleeps = iter([5, 0]), []
    monkeypatch.setenv("COOLDOWN", "7")
    monkeypatch.setattr(train_forever.subprocess, "call",
                        lambda cmd: next(calls))
    monkeypatch.setattr(train_forever.time, "sleep", sleeps.append)
    assert train_forever.main(["--epochs", "1"]) == 0
    assert sleeps == [7.0]


class _Stub:
    """An OpenAI-compatible endpoint on localhost in a thread:
    ``/v1/models`` and ``/v1/chat/completions`` (an answer of `ANSWERS` by
    a hash of the system prompt and the report); ``poll``, ``terminate``
    and ``wait`` as a server's process has them."""

    def __init__(self, port: int, model: str = "stub"):
        class Handler(BaseHTTPRequestHandler):
            def _send(self, body):
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path != "/v1/models":
                    self.send_error(404)
                    return
                self._send({"object": "list", "data": [{"id": model}]})

            def do_POST(self):
                if self.path != "/v1/chat/completions":
                    self.send_error(404)
                    return
                req = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                text = "".join(m["content"] for m in req["messages"])
                answer = ANSWERS[zlib.crc32(text.encode()) % len(ANSWERS)]
                self._send({"choices": [{"message": {
                    "role": "assistant", "content": answer}}]})

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def poll(self):
        return None

    def terminate(self):
        self.server.shutdown()
        self.server.server_close()

    def wait(self):
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _free_ports(n: int) -> int:
    """A base port with the `n` ports from it free on localhost."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free ports")


@pytest.fixture
def localhost_only(monkeypatch):
    """Requests to localhost go straight to it, in this process and in the
    workers it starts, whatever proxy the environment names."""
    for var in ("http_proxy", "https_proxy", "all_proxy", "HTTP_PROXY",
                "HTTPS_PROXY", "ALL_PROXY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("no_proxy", "localhost,127.0.0.1")
    monkeypatch.setenv("NO_PROXY", "localhost,127.0.0.1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_fleet_writes_the_csvs_of_one_run_and_of_the_jax_cli(
        tmp_path, localhost_only, monkeypatch):
    csv = tmp_path / "reports.csv"
    _reports(csv)
    base = _free_ports(2)
    started = []

    def start(model, port, gpu, log_path):
        assert (model, port - base, gpu) == ("stub", gpu, gpu)
        assert log_path == str(tmp_path / "fleet" / f"vllm_{gpu}.log")
        started.append(_Stub(port))
        return started[-1]

    monkeypatch.setenv("BASE_PORT", str(base))
    assert fleet.launch(str(csv), str(tmp_path / "fleet"), 2, "stub",
                        start_server=start) == 0
    assert len(started) == 2
    assert all(not s.thread.is_alive() for s in started)  # stopped
    parts = sorted(p.name for p in (tmp_path / "fleet").iterdir()
                   if p.name.startswith("raw_answers"))
    assert parts == ["raw_answers_part0.jsonl", "raw_answers_part1.jsonl"]

    stub = _Stub(base)
    try:
        for name, mod in (("one", trun), ("jax", jrun)):
            mod.main(["--reports", str(csv), "--out_dir", str(tmp_path / name),
                      "--base_url", f"http://localhost:{base}/v1",
                      "--model", "stub"])
    finally:
        stub.terminate()
        stub.wait()
    for table in ("per_tumor.csv", "per_ct.csv"):
        got = (tmp_path / "fleet" / table).read_bytes()
        assert got.count(b"\n") > 5, table
        assert got == (tmp_path / "one" / table).read_bytes(), table
        assert got == (tmp_path / "jax" / table).read_bytes(), table


FAILING_WORKER = """
import sys
sys.path.insert(0, {root!r})
from rsuper_tpu_torch.report_extraction.run import main
if sys.argv[sys.argv.index("--part") + 1] == "1":
    sys.exit(5)
main(sys.argv[1:])
"""


def test_fleet_fails_when_a_worker_fails(tmp_path, localhost_only, capsys,
                                         monkeypatch):
    csv = tmp_path / "reports.csv"
    _reports(csv)
    base = _free_ports(2)
    started = []

    def start(model, port, gpu, log_path):
        started.append(_Stub(port))
        return started[-1]

    worker = [sys.executable, "-c", FAILING_WORKER.format(root=str(ROOT))]
    monkeypatch.setenv("BASE_PORT", str(base))
    assert fleet.launch(str(csv), str(tmp_path / "out"), 2, "stub",
                        start_server=start, worker=worker) == 1
    assert "extraction workers [1] failed (exit codes [5])" in \
        capsys.readouterr().err
    assert (tmp_path / "out" / "raw_answers_part0.jsonl").exists()
    assert not (tmp_path / "out" / "raw_answers_part1.jsonl").exists()
    assert all(not s.thread.is_alive() for s in started)


def test_fleet_servers_and_usage(tmp_path):
    assert fleet.server_command("meta-llama/Llama-3.1-70B-Instruct-AWQ",
                                8003) == [
        "vllm", "serve", "meta-llama/Llama-3.1-70B-Instruct-AWQ", "--port",
        "8003", "--quantization", "awq"]
    assert fleet.main(["only_one_argument"]) == 2

    class Dead:
        returncode = 9

        def poll(self):
            return 9

    with pytest.raises(RuntimeError, match="exited with code 9"):
        fleet.wait_until_up([Dead()], [_free_ports(1)])
