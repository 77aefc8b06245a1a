"""`genmap-tpu-torch` processes started from the environment over gloo: the
port's counterpart of tests/test_distributed.py.

Each process exports GENMAP_DIST_COORDINATOR (a free localhost port),
GENMAP_DIST_NPROCS and GENMAP_DIST_PROC_ID and runs this file as a script:
the worker at the bottom calls the port's CLI with its arguments, "{rank}"
replaced by its process id, and exits with the CLI's code.  The CLI then
starts its torch.distributed world itself (`parallel/dist.py`
`maybe_initialize`, TCP rendezvous): `map --device cpu` on gloo, `index` on
gloo with no device bound, as the JAX package's `index` builds and writes
in every process.  Nothing here imports jax.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_TIMEOUT = 240  # seconds, per process


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(rank=None, nprocs=None, port=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("GENMAP_DIST")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    if rank is not None:
        env.update(GENMAP_DIST_COORDINATOR=f"localhost:{port}",
                   GENMAP_DIST_NPROCS=str(nprocs), GENMAP_DIST_PROC_ID=str(rank))
    return env


def _run(args, cwd, nprocs=None):
    """The CLI in one process without a world (nprocs None), or in `nprocs`
    processes of one world; returns each process's (code, output)."""
    if nprocs is None:
        envs = [_env()]
    else:
        port = _free_port()
        envs = [_env(r, nprocs, port) for r in range(nprocs)]
    logs = [open(os.path.join(cwd, f"log-{os.getpid()}-{r}.txt"), "w+")
            for r in range(len(envs))]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args],
                              env=env, cwd=str(cwd), stdout=log,
                              stderr=subprocess.STDOUT, text=True)
             for env, log in zip(envs, logs)]
    out = []
    try:
        for p, log in zip(procs, logs):
            code = p.wait(timeout=_TIMEOUT)
            log.seek(0)
            out.append((code, log.read()))
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return out


def _ok(results):
    for rank, (code, log) in enumerate(results):
        assert code == 0, f"process {rank} exited {code}:\n{log[-3000:]}"


def _tree(d):
    """{relative path: bytes} of every file under d."""
    files = {}
    for dirpath, _dirs, names in os.walk(d):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                files[os.path.relpath(path, d)] = f.read()
    return files


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(11)
    unit = rng.integers(0, 4, 80)
    chroms = {"chrA": np.concatenate([rng.integers(0, 4, 1500), np.tile(unit, 4),
                                      rng.integers(0, 4, 600)]),
              "chrB": rng.integers(0, 4, 900)}
    fa = d / "g.fa"
    with open(fa, "w") as f:
        for name, codes in chroms.items():
            f.write(f">{name}\n{_ACGT[codes].tobytes().decode()}\n")
    _ok(_run(["index", "-F", str(fa), "-I", str(d / "idx")], d))
    return d


@pytest.mark.timeout(600)
def test_two_processes_map_equals_one_process_and_only_rank_0_writes(genome):
    flags = ["-K", "12", "-E", "1", "-fl", "-t", "-bg", "-r", "--device", "cpu"]
    (genome / "one").mkdir()
    _ok(_run(["map", "-I", str(genome / "idx"), "-O", str(genome / "one") + "/",
              *flags], genome))
    want = _tree(genome / "one")
    assert want
    for r in range(2):
        (genome / f"world{r}").mkdir()
    _ok(_run(["map", "-I", str(genome / "idx"), "-O", str(genome / "world{rank}") + "/",
              *flags], genome, nprocs=2))
    assert _tree(genome / "world0") == want
    assert _tree(genome / "world1") == {}


@pytest.mark.timeout(600)
@pytest.mark.parametrize("nprocs", [1, 2])
def test_index_under_the_environment_builds_in_every_process(genome, nprocs):
    """On a host without a card, `index` under GENMAP_DIST_* returns 0 and
    writes the index a process without a world writes, in every process."""
    want = _tree(genome / "idx")
    out = genome / f"idx_world{nprocs}_{{rank}}"
    _ok(_run(["index", "-F", str(genome / "g.fa"), "-I", str(out)], genome,
             nprocs=nprocs))
    for r in range(nprocs):
        assert _tree(genome / f"idx_world{nprocs}_{r}") == want


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from genmap_tpu_torch.cli.main import main

    rank = os.environ.get("GENMAP_DIST_PROC_ID", "0")
    sys.exit(main([a.replace("{rank}", rank) for a in sys.argv[1:]]))
