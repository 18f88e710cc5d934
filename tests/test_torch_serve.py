"""The port's serving launcher (``repro_torch.launch.serve``).

A ``server`` and a ``client --device cpu`` run as subprocesses over TCP:
the client works a 2-prompt MMLU stream of one domain (a miss that
uploads, then a partial hit) and exits 0, and the server stops on SIGINT
with exit code 0. The ``--reduced`` flag is parsed in both packages: the
reference's is a ``store_true`` that defaults to true, so it cannot be
turned off (ROADMAP Queue 3); the port's ``--no-reduced`` turns it off.
Every subprocess wait is bounded.
"""
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import pytest

import repro.launch.serve as jax_serve
from repro_torch.launch import serve

SRC = str(Path(__file__).resolve().parents[1] / "src")
WAIT_S = 120


def _start_server():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "server",
         "--port", "0"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()         # the server's first line
    m = re.search(r"tcp://127\.0\.0\.1:(\d+)", line)
    if m is None:
        proc.kill()
        raise AssertionError(f"no server line: {line!r} "
                             f"{proc.communicate(timeout=WAIT_S)}")
    return proc, int(m.group(1))


def test_server_and_client_over_tcp():
    server, port = _start_server()
    try:
        env = dict(os.environ, PYTHONPATH=SRC)
        client = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "client",
             "--port", str(port), "--device", "cpu", "--prompts", "2",
             "--domains", "1", "--max-new", "4"], env=env,
            capture_output=True, text=True, timeout=WAIT_S)
    finally:
        server.send_signal(signal.SIGINT)
        out, err = server.communicate(timeout=WAIT_S)
    assert client.returncode == 0, client.stderr
    lines = client.stdout.splitlines()
    assert lines[0].startswith("client-0: gemma3-270m-reduced") and \
        lines[0].endswith("on cpu")
    cases = [int(re.search(r"case=(\d)", ln).group(1)) for ln in lines[1:]]
    assert cases == [1, 4], client.stdout
    assert all("abstract_algebra" in ln for ln in lines[1:])
    assert server.returncode == 0, err
    assert out.strip().endswith("cache server stopped")


def test_client_without_a_card_raises_and_does_not_fall_back(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.parser().parse_args(["client", "--port", "1"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        serve.run_client(args)


def test_reduced_flag_parses_in_both_packages(monkeypatch):
    ref = []
    monkeypatch.setattr(jax_serve, "run_client", ref.append)
    for argv in (["client"], ["client", "--reduced"]):
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        jax_serve.main()
    assert [a.reduced for a in ref] == [True, True]
    # the reference has no way to turn it off
    monkeypatch.setattr(sys, "argv", ["serve", "client", "--no-reduced"])
    with pytest.raises(SystemExit):
        jax_serve.main()
    p = serve.parser()
    assert p.parse_args(["client"]).reduced is True
    assert p.parse_args(["client", "--reduced"]).reduced is True
    assert p.parse_args(["client", "--no-reduced"]).reduced is False
    with pytest.raises(SystemExit):
        p.parse_args(["client", "--arch", "granite-moe-3b-a800m"])
