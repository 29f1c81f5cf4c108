"""What the benchmark imports: never JAX or the JAX package (top-level names
compared whole, since the port's name begins with the JAX package's), and the
references nothing of the port."""

import ast

import pytest

from portbench.tests.tiny import REPO

BENCH = REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "outline_rag_tpu"}


def imported(path) -> set[str]:
    """Top-level module names a file imports (relative imports excluded)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert "outline_rag_tpu_torch" not in imported(path)
    # nor through the benchmark's own modules it imports
    text = path.read_text()
    for line in text.splitlines():
        if line.startswith(("from portbench", "import portbench")):
            name = line.split()[1].split(".")
            target = BENCH.joinpath(*name[1:]).with_suffix(".py")
            if target.exists():
                assert "outline_rag_tpu_torch" not in imported(target), target


def test_the_walk_compares_whole_names():
    tree = ast.parse("import outline_rag_tpu_torch.engine\nfrom jaxtyping import x\n")
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    assert names == {"outline_rag_tpu_torch"} and not names & FORBIDDEN
