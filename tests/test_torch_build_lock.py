"""The kernel library's build is exclusive between processes.

``ray_tpu_torch/ops/_build.py`` compiles every ``ops/csrc/*.cu`` into an
object of a fixed name under ``BUILD_DIR`` and links them. Two processes
of the runtime on one host (a driver and a worker, or two workers) may
build at the same moment; without a lock each would write the same
objects and one could link the other's half-written files. Here two
processes call ``build()`` at one instant with a fake ``nvcc`` first on
``PATH``: it writes each object slowly, in lines that name its process,
and links by concatenating the objects. The library and every object
must each come whole from one compile.
"""

import os
import stat
import subprocess
import sys
import textwrap
import time

from ray_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = 4

FAKE_NVCC = textwrap.dedent(f"""\
    #!{sys.executable}
    import os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    if "-shared" in args:
        objs = [a for a in args if a.endswith(".o")]
        with open(out, "w") as f:
            for o in objs:
                f.write(open(o).read())
        sys.exit(0)
    src = os.path.basename(args[args.index("-c") + 1])
    with open(out, "w") as f:
        for i in range({PARTS}):
            f.write(f"{{os.getppid()}} {{src}} {{i}}\\n")
            f.flush()
            time.sleep(0.05)
    """)

CHILD = textwrap.dedent("""\
    import os, sys, time
    from pathlib import Path
    from ray_tpu_torch.ops import _build
    build_dir, go = Path(sys.argv[1]), sys.argv[2]
    _build.BUILD_DIR = build_dir
    _build.LIB_PATH = build_dir / "libkernels.so"
    while not os.path.exists(go):
        time.sleep(0.001)
    _build.build()
    """)


def _objects(text: str) -> list[list[str]]:
    """Lines grouped by (process, source), in order of appearance."""
    groups: list[list[str]] = []
    for line in text.splitlines():
        key = line.split()[:2]
        if not groups or groups[-1][0].split()[:2] != key:
            groups.append([])
        groups[-1].append(line)
    return groups


def _whole(group: list[str]) -> bool:
    return [int(line.split()[2]) for line in group] == list(range(PARTS))


def test_two_processes_build_one_consistent_library(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    build_dir = tmp_path / "build"
    go = tmp_path / "go"
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(build_dir), str(go)], env=env)
        for _ in range(2)]
    time.sleep(1.0)      # both children imported and waiting
    go.touch()
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    srcs = sorted(s.name for s in _build.sources())
    assert srcs, "no kernel sources found"
    lib = (build_dir / "libkernels.so").read_text()
    groups = _objects(lib)
    # One object per source, each whole and each from a single compile.
    assert [g[0].split()[1] for g in groups] == srcs
    assert all(_whole(g) for g in groups), lib
    # ... all by the same process: the one that built last.
    assert len({g[0].split()[0] for g in groups}) == 1, lib
    for src in _build.sources():
        obj = (build_dir / (src.stem + ".o")).read_text()
        assert len(_objects(obj)) == 1 and _whole(_objects(obj)[0]), obj
    assert not list(build_dir.glob("*.tmp"))
