"""The port's TeX typesetter (``outline_rag_tpu_torch/utils/texmath.py``, a
verbatim copy held by ``tests/test_torch_copies.py``): the JAX package's
Python-side cases of ``tests/test_texmath.py`` run on the copy, its output
equals the JAX module's on the same sources, and the JS port the port
serves (``outline_rag_tpu_torch/serve/static/tex.js``) carries the copy's
tables and renders as it does."""

import json
import re
import sys
from pathlib import Path

import pytest

import outline_rag_tpu.utils.texmath as jax_tm
import outline_rag_tpu_torch.utils.texmath as tm
from outline_rag_tpu_torch.utils.texmath import SYMBOLS, _split_rows, render_fragment, render_math

ROOT = Path(__file__).resolve().parents[1]
TEX_JS = ROOT / "outline_rag_tpu_torch" / "serve" / "static" / "tex.js"

FORMULAS = [
    r"E = mc^2",
    r"\frac{a+b}{c_1^2}",
    r"\operatorname{argmax}_x f(x)",
    r"\mathrm{d}x",
    r"\sqrt[3]{x+1}",
    r"\sum_{i=0}^{n} i^2",
    r"\begin{pmatrix} a & b \\ c & d \end{pmatrix}",
    r"\begin{cases} x & \begin{pmatrix} a \\ b \end{pmatrix} \\ y & z \end{cases}",
    r"\text{if } x > 0",
    r"\hat{y} \approx \alpha \cdot \beta",
    r"\left( \frac{a}{b} \right)",
    r"\int_{-\infty}^{\infty} e^{-x^2} \, dx = \sqrt{\pi}",
    r"\mathbf{v} \mathbb{R} \vec{v}",
    r"\notacommand{x}",
    "<script>alert(1)</script>",
    "{{{",
    "\\frac{",
]


def test_symbols_and_variables():
    h = render_fragment(r"\alpha + x \leq \infty")
    assert "α" in h and "≤" in h and "∞" in h
    assert '<i class="tex-v">x</i>' in h


def test_superscript_subscript():
    assert 'class="tex-sup">2' in render_fragment(r"x^2")
    h = render_fragment(r"a_{ij}^{2k}")
    assert 'class="tex-sub">' in h and 'class="tex-sup">' in h
    assert h.count("tex-scripts") == 1


def test_fraction_sqrt_text_and_accents():
    h = render_fragment(r"\frac{a+b}{\frac{c}{d}}")
    assert h.count('class="tex-frac"') == 2
    assert 'class="tex-root">' in render_fragment(r"\sqrt[3]{x+1}")
    assert '<span class="tex-text">if </span>' in render_fragment(r"\text{if } x > 0")
    assert render_fragment(r"\vec{v} \hat{x}").count("tex-accent-mark") == 2


def test_big_operators_functions_and_delimiters():
    h = render_fragment(r"\sum_{i=0}^{n} x_i")
    assert 'class="tex-op">∑' in h and "tex-limits" in h and "tex-scripts" in h
    h = render_fragment(r"\sin x + \log y")
    assert 'class="tex-fn">sin' in h and 'class="tex-fn">log' in h
    assert render_fragment(r"\left( \frac{a}{b} \right)").count("tex-stretchy") == 2
    assert "tex-stretchy" not in render_fragment(r"\left. x \right.")


def test_matrix_environments_and_escaped_braces():
    h = render_fragment(r"\begin{pmatrix} a & b \\ c & d \end{pmatrix}")
    assert h.count("tex-row") == 2 and h.count("tex-cell") == 4
    assert _split_rows(r"\{a\} & x \\ b & y") == [r"\{a\} & x ", "b & y"]
    h = render_math(r"\begin{cases} x & \begin{pmatrix} a \\ b \end{pmatrix} \\ y & z \end{cases}")
    assert h.count("tex-table") == 2 and "tex-unk" not in h


def test_escaping_wrappers_and_garbage():
    h = render_math("<script>alert(1)</script>")
    assert "<script>" not in h and "&lt;" in h
    assert "tex-unk" in render_fragment(r"\notacommand{x}")
    assert render_math("x", block=False).startswith('<span class="tex">')
    assert render_math("x", block=True).startswith('<div class="tex tex-block">')
    for garbage in ("{{{", "}}}", "\\", "^", "_^", "\\frac{", "\\begin{x}", "\\left", "\x00"):
        assert render_math(garbage).startswith("<")
    assert 'class="tex-text">argmax<' in render_math(r"\operatorname{argmax}")


@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("src", FORMULAS)
def test_copy_renders_as_the_jax_module(src, block):
    assert render_math(src, block=block) == jax_tm.render_math(src, block=block)


def test_served_js_port_carries_the_tables():
    src = TEX_JS.read_text()
    m = re.search(
        r"/\*SYMBOLS-BEGIN\*/\s*const TEX_SYMBOLS = (\{.*?\});\s*/\*SYMBOLS-END\*/", src, re.S
    )
    assert m and json.loads(m.group(1)) == SYMBOLS
    for name in ("FUNCTIONS", "BIG_OPS", "ACCENTS", "STYLES", "MATRIX_ENVS"):
        m = re.search(rf"/\*{name}-BEGIN\*/\s*const TEX_{name} = (.*?);\s*/\*{name}-END\*/",
                      src, re.S)
        assert m, name
        py_val, js_val = getattr(tm, name), json.loads(m.group(1))
        if isinstance(py_val, (set, frozenset)):
            assert set(js_val) == py_val, name
        elif name == "MATRIX_ENVS":
            assert {k: tuple(v) for k, v in js_val.items()} == py_val, name
        else:
            assert js_val == py_val, name


def test_served_js_port_renders_as_the_copy():
    sys.path.insert(0, str(ROOT / "tools"))
    from jsrt import Interpreter
    from jsrt.builtins import js_to_py

    interp = Interpreter()
    interp.run(TEX_JS.read_text())
    for f in FORMULAS[:10]:
        js = js_to_py(interp.call_any(interp.globals.lookup("texToHtml"), None, [f, False]))
        assert js == render_math(f), f
