#!/usr/bin/env python
"""A fleet of OpenAI-compatible LLM servers (vLLM) and one report
extraction worker a server: the counterpart of the JAX package's
``tools/launch_llm_fleet.sh`` (the reference's ``LaunchMultiGPUFlex.sh``).

    python -m rsuper_tpu_torch.launch_llm_fleet REPORTS_CSV OUT_DIR \\
        [N_INSTANCES [MODEL]]

N defaults to 1.

1. Starts ``vllm serve MODEL --port BASE_PORT+i --quantization awq`` on GPU
   i (``CUDA_VISIBLE_DEVICES=i``) for i < N, logging to ``OUT/vllm_i.log``;
   ``BASE_PORT`` (environment variable) defaults to 8000.
2. Polls ``http://localhost:PORT/v1/models`` every 5 s until each server
   answers.
3. Starts one worker a server, ``python -m
   rsuper_tpu_torch.report_extraction.run --reports REPORTS_CSV --out_dir
   OUT_DIR --base_url http://localhost:PORT/v1 --model MODEL --parts N
   --part i``.
4. Waits for the workers, then runs ``--postprocess_only``.

Unlike the script, a worker that exits non-zero, or a server that exits
before it answers, makes the launcher exit non-zero (without the
postprocessing), and the servers it started are stopped when it ends.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from typing import Callable, List, Sequence

DEFAULT_MODEL = "meta-llama/Llama-3.1-70B-Instruct-AWQ"
WORKER = (sys.executable, "-m", "rsuper_tpu_torch.report_extraction.run")
POLL_S = 5.0


def server_command(model: str, port: int) -> List[str]:
    """The command line of the server on `port`."""
    return ["vllm", "serve", model, "--port", str(port), "--quantization",
            "awq"]


def start_vllm(model: str, port: int, gpu: int, log_path: str):
    """Start the server on `port` on GPU `gpu`, its output to `log_path`;
    returns its ``Popen``."""
    with open(log_path, "wb") as log:
        return subprocess.Popen(
            server_command(model, port), stdout=log,
            stderr=subprocess.STDOUT,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": str(gpu)})


def _answers(url: str) -> bool:
    try:
        with urllib.request.urlopen(url, timeout=POLL_S):
            return True
    except (urllib.error.URLError, OSError):
        return False


def wait_until_up(servers, ports: Sequence[int]):
    """Poll each server's ``/v1/models`` until it answers; raises
    ``RuntimeError`` when one exits first."""
    for server, port in zip(servers, ports):
        while not _answers(f"http://localhost:{port}/v1/models"):
            if server.poll() is not None:
                raise RuntimeError(f"the server on port {port} exited with "
                                   f"code {server.returncode} before it "
                                   "answered")
            time.sleep(POLL_S)


def launch(reports: str, out: str, n: int, model: str = DEFAULT_MODEL,
           start_server: Callable = start_vllm,
           worker: Sequence[str] = WORKER) -> int:
    """Steps 1-4 of the module docstring; returns the postprocessing's
    exit code, or 1 when a worker failed. ``start_server(model, port, gpu,
    log_path)`` starts one server and returns a handle with ``poll``,
    ``terminate`` and ``wait`` (a ``Popen``); `worker` is the extraction
    command before its flags."""
    base_port = int(os.environ.get("BASE_PORT", "8000"))
    ports = [base_port + i for i in range(n)]
    os.makedirs(out, exist_ok=True)
    servers = []
    try:
        for i, port in enumerate(ports):
            servers.append(start_server(
                model, port, i, os.path.join(out, f"vllm_{i}.log")))
        wait_until_up(servers, ports)
        workers = [subprocess.Popen([
            *worker, "--reports", reports, "--out_dir", out, "--base_url",
            f"http://localhost:{port}/v1", "--model", model, "--parts",
            str(n), "--part", str(i)]) for i, port in enumerate(ports)]
        failed = [i for i, w in enumerate(workers) if w.wait() != 0]
        if failed:
            print(f"extraction workers {failed} failed (exit codes "
                  f"{[workers[i].returncode for i in failed]}); not "
                  "postprocessing", file=sys.stderr, flush=True)
            return 1
        return subprocess.call([*worker, "--reports", reports, "--out_dir",
                                out, "--postprocess_only"])
    finally:
        for server in servers:
            server.terminate()
        for server in servers:
            server.wait()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not 2 <= len(argv) <= 4:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    n = int(argv[2]) if len(argv) > 2 else 1
    return launch(argv[0], argv[1], n,
                  argv[3] if len(argv) > 3 else DEFAULT_MODEL)


if __name__ == "__main__":
    sys.exit(main())
