"""The port coordinator's SSH branch, driven for real (``tests/test_ssh_launch.py``'s
cases on the port).

- **stub transport** (always runs): the real ``Coordinator`` code path —
  option construction, strategy shipping into the worker's
  ``DEFAULT_STRATEGY_DIR``, the remote command (the port's per-node
  launcher starting the node's ranks), the env contract, monitor and join
  — through ``ssh``/``scp`` shims on PATH that run the command locally.
  Nothing inside the coordinator is mocked.
- **real sshd** (skipped where no ``sshd`` binary exists, as in the JAX
  package's file): the same flow against a throwaway sshd on 127.0.0.1.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.model_item import ModelItem, OptimizerSpec
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime.cluster import Cluster
from autodist_tpu_torch.runtime.coordinator import Coordinator
from autodist_tpu_torch.strategy import AllReduce

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def importable(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))


def _make_strategy(gpus=1):
    item = ModelItem.from_params({"w": torch.zeros(4, 2)},
                                 optimizer_spec=OptimizerSpec("sgd", {"learning_rate": 0.1}))
    spec = ResourceSpec(resource_dict={"nodes": [
        {"address": "10.99.0.1", "gpus": gpus, "chief": True},
        {"address": "10.99.0.2", "gpus": gpus}]})
    strategy = AllReduce().build(item, spec)
    strategy.serialize()
    return spec, strategy


def _write_stub_transport(bin_dir, log_path):
    """``ssh``/``scp`` shims that record their argv and run locally."""
    bin_dir.mkdir(parents=True, exist_ok=True)
    ssh = bin_dir / "ssh"
    ssh.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        echo "ssh $@" >> {log_path}
        while [ $# -gt 0 ]; do
          case "$1" in
            -o|-p|-i) shift 2 ;;
            -*) shift ;;
            *) break ;;
          esac
        done
        shift
        exec sh -c "$1"
    """))
    scp = bin_dir / "scp"
    scp.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        echo "scp $@" >> {log_path}
        while [ $# -gt 0 ]; do
          case "$1" in
            -o|-P|-i) shift 2 ;;
            -*) shift ;;
            *) break ;;
          esac
        done
        src="$1"
        dest="${{2#*:}}"
        [ "$src" = "$dest" ] || cp "$src" "$dest"
    """))
    ssh.chmod(0o755)
    scp.chmod(0o755)


def test_ssh_branch_end_to_end_with_stub_transport(tmp_path, monkeypatch):
    log_path = tmp_path / "transport.log"
    _write_stub_transport(tmp_path / "bin", log_path)
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    proof = tmp_path / "proof"
    proof.mkdir()
    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent(f"""\
        import json, os
        sid = os.environ["AUTODIST_STRATEGY_ID"]
        spath = os.path.join({const.DEFAULT_STRATEGY_DIR!r}, sid)
        json.dump({{k: os.environ.get(k) for k in (
            "AUTODIST_WORKER", "AUTODIST_PROCESS_ID", "AUTODIST_NUM_PROCESSES", "RANK",
            "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR")}}
                  | {{"strategy_file_exists": os.path.exists(spath), "cwd": os.getcwd()}},
                  open(os.path.join({str(proof)!r}, os.environ["RANK"]), "w"))
    """))
    spec, strategy = _make_strategy(gpus=2)
    coord = Coordinator(Cluster(spec), strategy, argv=[sys.executable, str(worker)])
    coord.launch_clients()
    coord.join()
    assert not coord.any_failed
    got = {r: json.load(open(proof / str(r))) for r in (2, 3)}
    for r, g in got.items():
        assert g["AUTODIST_WORKER"] == "10.99.0.2"
        assert g["AUTODIST_PROCESS_ID"] == g["RANK"] == str(r)   # chief's 2 ranks first
        assert g["AUTODIST_NUM_PROCESSES"] == g["WORLD_SIZE"] == "4"
        assert (g["LOCAL_RANK"], g["LOCAL_WORLD_SIZE"]) == (str(r - 2), "2")
        assert g["MASTER_ADDR"] == "10.99.0.1"
        assert g["strategy_file_exists"] and g["cwd"] == os.getcwd()
    log = log_path.read_text()
    assert "mkdir -p" in log and "scp" in log and strategy.id in log
    assert "AUTODIST_WORKER=10.99.0.2" in log and "--node-local-ranks 2" in log


def test_ssh_config_flags_reach_the_transport(tmp_path, monkeypatch):
    log_path = tmp_path / "transport.log"
    _write_stub_transport(tmp_path / "bin", log_path)
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    key = tmp_path / "id_test"
    key.write_text("not-a-real-key")
    spec = ResourceSpec(resource_dict={
        "nodes": [{"address": "10.99.0.1", "gpus": 1, "chief": True},
                  {"address": "10.99.0.2", "gpus": 1, "ssh_config": "worker"}],
        "ssh": {"worker": {"user": "gpu", "port": 2222, "key_file": str(key)}}})
    rt = ResourceSpec(resource_dict=spec.to_dict())
    cfg = rt.ssh_config_for("10.99.0.2")
    assert (cfg.user, cfg.port, cfg.key_file) == ("gpu", 2222, str(key))
    assert rt.ssh_config_for("10.99.0.1") is None
    with pytest.raises(ValueError, match="ssh_config"):
        ResourceSpec(resource_dict={"nodes": [
            {"address": "10.99.0.1", "gpus": 1, "chief": True},
            {"address": "10.99.0.2", "gpus": 1, "ssh_config": "missing"}]})
    worker = tmp_path / "worker.py"
    worker.write_text("print('hi')\n")
    coord = Coordinator(Cluster(spec), None, argv=[sys.executable, str(worker)])
    coord.launch_clients()
    coord.join()
    log = log_path.read_text()
    assert "-p 2222" in log and f"-i {key}" in log and "gpu@10.99.0.2" in log


def test_failed_remote_rank_fails_the_node(tmp_path, monkeypatch):
    """A rank dying on a remote node ends that node's agent non-zero, which
    the chief's monitor turns into the failure action."""
    import threading

    _write_stub_transport(tmp_path / "bin", tmp_path / "transport.log")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    script = tmp_path / "w.py"
    script.write_text("import os, time\n"
                      "if os.environ['LOCAL_RANK'] == '1':\n    raise SystemExit(4)\n"
                      "time.sleep(60)\n")
    spec, _ = _make_strategy(gpus=2)
    coord = Coordinator(Cluster(spec), None, argv=[sys.executable, str(script)])
    fired = threading.Event()
    coord.set_failure_action(fired.set)
    t0 = time.monotonic()
    coord.launch_clients()
    assert fired.wait(timeout=60) and coord.any_failed
    assert coord.procs[0].wait(timeout=60) == 4
    assert time.monotonic() - t0 < 45


@pytest.mark.skipif(shutil.which("sshd") is None, reason="no sshd binary")
def test_ssh_branch_against_real_sshd(tmp_path, monkeypatch):
    import autodist_tpu_torch.resource_spec as rs_mod
    import autodist_tpu_torch.runtime.coordinator as coord_mod

    host_key, user_key = tmp_path / "host_key", tmp_path / "user_key"
    for k in (host_key, user_key):
        subprocess.run(["ssh-keygen", "-q", "-t", "ed25519", "-N", "", "-f", str(k)],
                       check=True)
    auth = tmp_path / "authorized_keys"
    auth.write_text(user_key.with_suffix(".pub").read_text())
    auth.chmod(0o600)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = tmp_path / "sshd_config"
    cfg.write_text(f"Port {port}\nListenAddress 127.0.0.1\nHostKey {host_key}\n"
                   f"AuthorizedKeysFile {auth}\nPasswordAuthentication no\n"
                   f"StrictModes no\nPidFile {tmp_path}/sshd.pid\n")
    sshd = subprocess.Popen([shutil.which("sshd"), "-D", "-f", str(cfg)],
                            stderr=subprocess.DEVNULL)
    try:
        time.sleep(1.0)
        monkeypatch.setattr(rs_mod, "_LOOPBACK_ADDRESSES", ())
        monkeypatch.setattr(coord_mod, "_is_local", lambda a: False)
        spec = ResourceSpec(resource_dict={
            "nodes": [{"address": socket.gethostname(), "gpus": 1, "chief": True},
                      {"address": "127.0.0.1", "gpus": 1, "ssh_config": "w"}],
            "ssh": {"w": {"port": port, "key_file": str(user_key)}}})
        proof = tmp_path / "proof.txt"
        worker = tmp_path / "worker.py"
        worker.write_text(f"import os; open({str(proof)!r}, 'w').write("
                          f"os.environ['AUTODIST_WORKER'])\n")
        coord = Coordinator(Cluster(spec), None, argv=[sys.executable, str(worker)])
        coord.launch_clients()
        coord.join()
        assert proof.read_text() == "127.0.0.1"
    finally:
        sshd.terminate()
