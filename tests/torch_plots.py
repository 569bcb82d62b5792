"""Helper of the plot tests: run a simulation of either package in its own
directory and collect what it printed and which files it wrote."""

import contextlib
import io
import os
from pathlib import Path


def run_in(directory: Path, fn, *args, **kw):
    """Call fn(*args, **kw) with ``directory`` as the working directory (the
    simulations write under the relative ``plots/``).  Returns (result,
    printed lines with the directory's path replaced by ``<dir>``, sorted
    paths of every file written, relative to the directory)."""
    directory.mkdir(parents=True, exist_ok=True)
    buf = io.StringIO()
    with contextlib.chdir(directory), contextlib.redirect_stdout(buf):
        result = fn(*args, **kw)
    root = str(directory.resolve())
    lines = buf.getvalue().replace(root, "<dir>").splitlines()
    files = sorted(str(p.relative_to(directory)) for p in directory.rglob("*") if p.is_file())
    return result, lines, files


def assert_same_run(tmp_path: Path, jax_fn, port_fn, *args, **kw):
    """Both packages' run of the same call: equal prints and equal file
    names, at least one PNG.  ``kw`` goes to the port's call only (its
    ``device``)."""
    jr, jlines, jfiles = run_in(tmp_path / "jax", jax_fn, *args)
    tr, tlines, tfiles = run_in(tmp_path / "port", port_fn, *args, **kw)
    assert tfiles == jfiles and any(f.endswith(".png") for f in tfiles), (tfiles, jfiles)
    assert tlines == jlines
    for f in tfiles:
        assert os.path.getsize(tmp_path / "port" / f) > 0
    return jr, tr, tfiles
