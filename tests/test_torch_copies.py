"""The port keeps its own copies of the JAX package's framework-free
modules (ROADMAP.md's ground rules): this file holds each copy to its
original, so the two packages cannot drift apart unseen.

- A copied module's text equals the JAX module's once ``outline_rag_tpu``
  is renamed ``outline_rag_tpu_torch``; a static asset is byte-equal. The
  minified bundle (``script.min.js``, ``style.min.css``) is a git-ignored
  build output of ``tools/build_assets.py`` in the JAX package and a
  committed file in the port: the port's is byte-equal to a build from the
  JAX sources, and to the JAX package's own file where one was built.
- An adapted copy differs only by the lines listed for it here.
- No file of the port, and not ``chip_smoke.py``, names a path into the
  JAX package's directory (a file read from there would tie the port to
  the reference as surely as an import): no string literal of a module,
  and no line of a build file or of a served asset outside its comments.
  Docstrings, comments and ``file.py:line`` citations (``chip_smoke.py``'s
  ``replaces`` fields) name the reference without reading it. C++ and CUDA
  sources read no files."""

import ast
import contextlib
import difflib
import importlib.util
import io
import re
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "outline_rag_tpu", ROOT / "outline_rag_tpu_torch"
RENAME = re.compile(r"\boutline_rag_tpu\b")

COPIES = [
    "config.py",
    "utils/__init__.py",
    "utils/hashing.py",
    "utils/logging.py",
    "utils/chunking.py",
    "utils/texmath.py",
    "native/__init__.py",
    "native/chunker.cc",
    "native/httpparse.cc",
    "native/Makefile",
    "storage/__init__.py",
    "storage/bus.py",
    "storage/sqlite.py",
    "storage/resp.py",
    "storage/pgwire.py",
    "storage/postgres.py",
    "models/hash_embedder.py",
    "models/tokenizer.py",
    "sync/__init__.py",
    "serve/http.py",
    "serve/chat.py",
]
STATIC = ["index.html", "app.js", "tex.js", "style.css", "favicon.svg", "script.min.js",
          "style.min.css"]
MINIFIED = ("script.min.js", "style.min.css")


def built_bundle(directory: Path) -> dict[str, bytes]:
    """The JAX package's minified bundle as ``tools/build_assets.py`` builds
    it from the JAX sources, built in ``directory`` (the tool's module is
    loaded afresh and pointed there: nothing is written into the package)."""
    spec = importlib.util.spec_from_file_location("build_assets_copy",
                                                  ROOT / "tools" / "build_assets.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name in (*tool.JS_BUNDLE, "style.css"):
        shutil.copy(JAX / "serve" / "static" / name, directory / name)
    tool.STATIC = str(directory)
    with contextlib.redirect_stdout(io.StringIO()):
        tool.main()
    return {name: (directory / name).read_bytes() for name in MINIFIED}

# adapted copies: (lines only the JAX module has, lines only the port's has),
# stripped, blank lines left out
ADAPTED = {
    # httpx is imported where a client is built, so the app imports without it
    "sync/outline.py": (
        ["import httpx"],
        ["import httpx  # here, not at import: the app imports without httpx", "import httpx"],
    ),
    "serve/auth.py": (
        ["import httpx",
         "self._client = httpx.AsyncClient(transport=transport, timeout=15.0)"],
        ["self._transport = transport",
         "self._http = None",
         "@property",
         "def _client(self):",
         "# built at first use, not with the routes: the app (and its dev",
         "# login) serves on a machine without httpx",
         "if self._http is None:",
         "import httpx",
         "self._http = httpx.AsyncClient(transport=self._transport, timeout=15.0)",
         "return self._http"],
    ),
    # the entry point runs only as a script, not when a test imports it
    "__main__.py": (
        ["main()"],
        ['if __name__ == "__main__":  # not on import: tests import every module of the package',
         "main()"],
    ),
    # the ColBERT head's width, read from the port's encoder module
    "sync/refresh.py": (
        ['hc = inner.params["colbert"]["w"].shape[1]'],
        ["hc = inner.encoder.colbert.out_features"],
    ),
    # trace() captures through torch.profiler instead of jax.profiler
    "utils/profiling.py": (
        ["- :func:`trace` — context-manager wrapper over ``jax.profiler.trace`` for",
         "on-demand XLA trace capture (set ORT_TRACE_DIR or pass a path);",
         '"""Capture a jax profiler trace into ``path`` (or ORT_TRACE_DIR).',
         "import jax",
         "with jax.profiler.trace(target):"],
        ["- :func:`trace` — context-manager wrapper over ``torch.profiler`` for",
         "on-demand trace capture (set ORT_TRACE_DIR or pass a path);",
         '"""Capture a torch profiler trace (host and, where there is one, CUDA',
         "activity) into ``path`` (or ORT_TRACE_DIR) as a Chrome trace file.",
         "import torch",
         "activities = [torch.profiler.ProfilerActivity.CPU]",
         "if torch.cuda.is_available():",
         "activities.append(torch.profiler.ProfilerActivity.CUDA)",
         "os.makedirs(target, exist_ok=True)",
         "with torch.profiler.profile(activities=activities) as prof:",
         'prof.export_chrome_trace(os.path.join(target, f"trace_{os.getpid()}_{time.time_ns()}.json"))'],
    ),
}


def _renamed(rel: str) -> str:
    return RENAME.sub("outline_rag_tpu_torch", (JAX / rel).read_text())


@pytest.mark.parametrize(
    "rel", COPIES + sorted(ADAPTED) + [f"serve/static/{name}" for name in STATIC]
)
def test_copy_matches_the_jax_module(rel, tmp_path):
    name = rel.removeprefix("serve/static/")
    if name in MINIFIED:
        assert (PORT / rel).read_bytes() == built_bundle(tmp_path)[name]
    if rel.startswith("serve/static/"):
        if name not in MINIFIED or (JAX / rel).exists():
            assert (PORT / rel).read_bytes() == (JAX / rel).read_bytes()
        return
    port = (PORT / rel).read_text()
    if rel not in ADAPTED:
        assert port == _renamed(rel)
        return
    diff = list(difflib.ndiff(_renamed(rel).splitlines(), port.splitlines()))
    only_jax = [ln[2:].strip() for ln in diff if ln.startswith("- ") and ln[2:].strip()]
    only_port = [ln[2:].strip() for ln in diff if ln.startswith("+ ") and ln[2:].strip()]
    assert (only_jax, only_port) == ADAPTED[rel]


def _literal_strings(source: str) -> list[str]:
    """String constants of a module other than docstrings."""
    tree = ast.parse(source)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


# a path component "outline_rag_tpu" (not "outline_rag_tpu_torch")
PATH_INTO_JAX = re.compile(r"(^|[/\\\"'\s])outline_rag_tpu([/\\]|$)")
CITATION = re.compile(r"outline_rag_tpu/[\w/]+\.py:\d+")
ASSET_COMMENTS = re.compile(r"/\*.*?\*/|<!--.*?-->|(?<![:\\])//[^\n]*", re.S)


def _names_jax_path(text: str) -> bool:
    return bool(PATH_INTO_JAX.search(CITATION.sub("", text)))


def test_no_port_file_names_a_path_into_the_jax_package():
    files = [p for p in PORT.rglob("*") if p.is_file() and "__pycache__" not in p.parts
             and "build" not in p.relative_to(PORT).parts]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 60
    bad = []
    for path in files:
        if path.suffix == ".py":
            source = path.read_text()
            if any(_names_jax_path(s) for s in _literal_strings(source)):
                bad.append(str(path.relative_to(ROOT)))
        elif path.suffix in (".html", ".js", ".css", ".svg", "") and _names_jax_path(
                ASSET_COMMENTS.sub("", path.read_text(errors="replace"))):
            bad.append(str(path.relative_to(ROOT)))
    assert not bad, bad


def test_the_path_guard_sees_a_path_into_the_jax_package():
    """The guard above is only a check if it fails where it should."""
    for code in ('os.path.join(ROOT, "outline_rag_tpu", "serve")',
                 'STATIC = "outline_rag_tpu/serve/static"', "open('../outline_rag_tpu/native/x')"):
        assert any(_names_jax_path(s) for s in _literal_strings(code)), code
    for code in ('STATIC = "outline_rag_tpu_torch/serve/static"',
                 '"""See outline_rag_tpu/serve/app.py."""', "x = 1  # outline_rag_tpu/main.py",
                 'row = {"replaces": "outline_rag_tpu/ops/topk.py:346"}'):
        assert not any(_names_jax_path(s) for s in _literal_strings(code)), code
    assert _names_jax_path(ASSET_COMMENTS.sub("", 'fetch("/outline_rag_tpu/x.js") // y'))
    assert not _names_jax_path(ASSET_COMMENTS.sub("", "/* in outline_rag_tpu/utils */ x = 1"))


def _function_body(path: Path, name: str) -> list[str]:
    """The statements of function ``name`` in ``path`` (docstring left
    out), each as ``ast.dump`` gives it."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)
    body = [s for s in fn.body
            if not (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant))]
    return [ast.dump(s) for s in body]


def test_host_slice_arithmetic_is_the_jax_packages():
    """``parallel/multihost.py``'s slice arithmetic is copied: the JAX
    ``host_slice`` reads the process index and count from ``jax`` and
    computes the rest; the port's ``_host_slice`` takes them as arguments
    and computes the rest with the same statements."""
    jax_body = _function_body(JAX / "parallel" / "multihost.py", "host_slice")
    port_body = _function_body(PORT / "parallel" / "multihost.py", "_host_slice")
    assert "process_index" in jax_body[0]  # h, nh = jax.process_index(), jax.process_count()
    assert port_body == jax_body[1:]
