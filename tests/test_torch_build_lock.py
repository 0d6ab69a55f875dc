"""The kernel build's lock across processes (clearml_serving_tpu_torch/
ops/_build.py).

The object files have fixed names, so two processes that reach their first
kernel together on a cold tree (a process fleet's workers) would run the
compiler into the same files. Held here against a stub compiler that logs
each run's start and end: with two processes calling ``build()`` at once,
the runs never overlap, the sources compile once (three compiles and one
link), and both processes return the same library, current by its stamp.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

STUB = textwrap.dedent('''\
    #!{python}
    import os, sys, time
    log = os.environ["STUB_NVCC_LOG"]
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(log, "a") as fh:
        fh.write("start {{}} {{}} {{!r}}\\n".format(os.getppid(), time.monotonic(), out))
    time.sleep(0.3)
    with open(out, "wb") as fh:
        fh.write(b"stub")
    with open(log, "a") as fh:
        fh.write("end {{}} {{}} {{!r}}\\n".format(os.getppid(), time.monotonic(), out))
''')

BUILD_SCRIPT = textwrap.dedent('''\
    import sys
    from pathlib import Path
    from clearml_serving_tpu_torch.ops import _build
    _build.BUILD_DIR = Path(sys.argv[1])
    _build._nvcc = lambda: sys.argv[2]
    print(_build.build())
''')


def _run_two(tmp_path):
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(python=sys.executable))
    stub.chmod(0o755)
    log = tmp_path / "nvcc.log"
    build_dir = tmp_path / "kernels"
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["STUB_NVCC_LOG"] = str(log)
    env["PYTHONPATH"] = str(root)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(build_dir), str(stub)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    return [o[0].strip() for o in outs], log.read_text().splitlines(), build_dir


def _intervals(lines):
    """Each compiler run's (building process's pid, start, end)."""
    starts, out = {}, []
    for line in lines:
        kind, pid, t, target = line.split(" ", 3)
        if kind == "start":
            starts[(pid, target)] = float(t)
        else:
            out.append((pid, starts.pop((pid, target)), float(t)))
    assert not starts
    return out


def test_two_processes_build_once_and_never_at_once(tmp_path):
    libs, lines, build_dir = _run_two(tmp_path)
    runs = _intervals(lines)
    # the sources compile once, then link once: one process did the work
    assert len(runs) == 4
    assert len({pid for pid, _, _ in runs}) == 1
    assert libs[0] == libs[1] == str(build_dir / "libtpu_torch_kernels.so")
    assert (build_dir / "libtpu_torch_kernels.so.sha256").exists()


def test_a_build_waits_for_the_lock_holder(tmp_path):
    """While another process holds the build directory's lock, a build
    runs no compiler; once the lock is released it builds."""
    import fcntl
    import time

    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(python=sys.executable))
    stub.chmod(0o755)
    log = tmp_path / "nvcc.log"
    build_dir = tmp_path / "kernels"
    build_dir.mkdir()
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(STUB_NVCC_LOG=str(log), PYTHONPATH=str(root))
    with open(build_dir / ".lock", "a") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        proc = subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(build_dir), str(stub)],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        try:
            time.sleep(3.0)
            assert proc.poll() is None
            assert not log.exists()
        finally:
            fcntl.flock(held, fcntl.LOCK_UN)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    assert len(_intervals(log.read_text().splitlines())) == 4
