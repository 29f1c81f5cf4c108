"""The kernel build (``ops/_build.py``) with a stand-in ``nvcc``: one
compile per ``csrc/*.cu``, all started together, then one link; a failed
compile raises and leaves no library or objects behind. (The real build
runs on the card's machine: ``tests/test_torch_cuda.py``.)"""

import stat
import sys

import pytest

from outline_rag_tpu_torch.ops import _build

FAKE_NVCC = """#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
def log(what):
    with open(os.path.join({log!r}, "calls"), "a") as f:
        f.write(what + " " + repr(time.time()) + "\\n")
if "-c" in args:
    log("compile")
    if os.path.exists(os.path.join({log!r}, "fail")) and args[-1].endswith("topk_float.cu"):
        sys.exit(3)
    time.sleep(1)
    log("done")
else:
    log("link")
with open(out, "w") as f:
    f.write("built")
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(tmp_path)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_built", None)
    return tmp_path


def _calls(tmp_path):
    return [line.split() for line in (tmp_path / "calls").read_text().splitlines()]


def test_each_source_compiles_at_once_then_links(fake_build):
    built = _build.build_library()
    assert built.path.read_text() == "built"
    calls = _calls(fake_build)
    n_cu = len([s for s in _build._sources() if s.suffix == ".cu"])
    starts = [float(t) for what, t in calls if what == "compile"]
    ends = [float(t) for what, t in calls if what == "done"]
    assert len(starts) == len(ends) == n_cu and calls[-1][0] == "link"
    assert max(starts) < min(ends)  # every compile ran before any finished
    assert not list((fake_build / "build").glob("*.o"))
    assert _build.build_library() is built  # cached in the process


def test_failed_compile_raises_and_leaves_nothing(fake_build):
    (fake_build / "fail").touch()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_library()
    assert not list((fake_build / "build").iterdir())
    assert "link" not in [c[0] for c in _calls(fake_build)]
