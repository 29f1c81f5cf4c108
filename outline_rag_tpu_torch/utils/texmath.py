"""Self-contained TeX-math -> HTML typesetter (KaTeX-class subset).

The reference renders LaTeX with KaTeX from a CDN (reference
``app/static/js/core.js:190-244``, ``index.html:12-22``); this app is
zero-CDN, so it ships its own typesetter. This module is the CANONICAL
implementation: the browser runs a line-faithful JS port
(``serve/static/tex.js``) whose symbol table is verified byte-identical
against :data:`SYMBOLS` by ``tests/test_texmath.py`` (no JS runtime
exists in this environment, so the algorithm is pinned here and the port
is kept mechanically parallel).

Supported subset (the constructs wiki answers actually use):
- symbols: greek, operators, relations, arrows, \\infty, \\partial, ...
- ``^`` / ``_`` with ``{...}`` groups (and combined sup+sub)
- ``\\frac{a}{b}``, ``\\dfrac``, ``\\sqrt[n]{x}``, ``\\binom{n}{k}``
- ``\\text{...}`` / ``\\mathrm`` / ``\\mathbf`` / ``\\mathit`` / ``\\mathbb`` / ``\\mathcal``
- accents: ``\\vec`` ``\\hat`` ``\\bar`` ``\\dot`` ``\\tilde`` ``\\overline``
- ``\\left( ... \\right)`` stretchy delimiters
- environments: ``matrix`` / ``pmatrix`` / ``bmatrix`` / ``vmatrix`` /
  ``cases`` / ``align`` / ``aligned`` (rows ``\\\\``, cells ``&``)
- big operators (``\\sum`` ``\\prod`` ``\\int`` ...) with limit scripts

Unknown commands degrade to literal text with class ``tex-unk`` — the
renderer never raises on user/LLM input.

Output is pure HTML spans styled by ``serve/static/style.css`` (classes
prefixed ``tex-``). All text content is HTML-escaped.
"""

from __future__ import annotations

import html

# --- symbol table ----------------------------------------------------------
# KEEP IN SYNC with serve/static/tex.js (between the SYMBOLS-BEGIN/END
# markers); tests/test_texmath.py compares the two byte-for-byte.
SYMBOLS: dict[str, str] = {
    # greek (lower)
    "alpha": "α", "beta": "β", "gamma": "γ", "delta": "δ",
    "epsilon": "ε", "varepsilon": "ε", "zeta": "ζ",
    "eta": "η", "theta": "θ", "vartheta": "ϑ",
    "iota": "ι", "kappa": "κ", "lambda": "λ", "mu": "μ",
    "nu": "ν", "xi": "ξ", "pi": "π", "varpi": "ϖ",
    "rho": "ρ", "sigma": "σ", "varsigma": "ς", "tau": "τ",
    "upsilon": "υ", "phi": "φ", "varphi": "ϕ", "chi": "χ",
    "psi": "ψ", "omega": "ω",
    # greek (upper)
    "Gamma": "Γ", "Delta": "Δ", "Theta": "Θ",
    "Lambda": "Λ", "Xi": "Ξ", "Pi": "Π", "Sigma": "Σ",
    "Upsilon": "Υ", "Phi": "Φ", "Psi": "Ψ", "Omega": "Ω",
    # binary operators
    "times": "×", "div": "÷", "cdot": "⋅", "pm": "±",
    "mp": "∓", "ast": "∗", "star": "⋆", "circ": "∘",
    "bullet": "∙", "oplus": "⊕", "ominus": "⊖",
    "otimes": "⊗", "oslash": "⊘", "odot": "⊙",
    "wedge": "∧", "vee": "∨", "cap": "∩", "cup": "∪",
    "setminus": "∖",
    # relations
    "leq": "≤", "le": "≤", "geq": "≥", "ge": "≥",
    "neq": "≠", "ne": "≠", "approx": "≈", "equiv": "≡",
    "sim": "∼", "simeq": "≃", "cong": "≅",
    "propto": "∝", "ll": "≪", "gg": "≫",
    "subset": "⊂", "supset": "⊃", "subseteq": "⊆",
    "supseteq": "⊇", "in": "∈", "notin": "∉", "ni": "∋",
    "perp": "⊥", "parallel": "∥", "mid": "∣",
    "prec": "≺", "succ": "≻", "vdash": "⊢", "models": "⊨",
    # arrows
    "to": "→", "rightarrow": "→", "leftarrow": "←",
    "leftrightarrow": "↔", "Rightarrow": "⇒",
    "Leftarrow": "⇐", "Leftrightarrow": "⇔", "iff": "⇔",
    "implies": "⟹", "mapsto": "↦", "uparrow": "↑",
    "downarrow": "↓", "hookrightarrow": "↪",
    "longrightarrow": "⟶", "rightharpoonup": "⇀",
    # big operators
    "sum": "∑", "prod": "∏", "coprod": "∐", "int": "∫",
    "iint": "∬", "oint": "∮", "bigcup": "⋃",
    "bigcap": "⋂", "bigoplus": "⨁", "bigotimes": "⨂",
    "bigvee": "⋁", "bigwedge": "⋀",
    # misc
    "infty": "∞", "partial": "∂", "nabla": "∇",
    "forall": "∀", "exists": "∃", "nexists": "∄",
    "emptyset": "∅", "varnothing": "∅", "neg": "¬",
    "lnot": "¬", "land": "∧", "lor": "∨",
    "angle": "∠", "triangle": "△", "square": "□",
    "hbar": "ℏ", "ell": "ℓ", "Re": "ℜ", "Im": "ℑ",
    "aleph": "ℵ", "wp": "℘", "prime": "′",
    "dots": "…", "ldots": "…", "cdots": "⋯",
    "vdots": "⋮", "ddots": "⋱", "therefore": "∴",
    "because": "∵", "degree": "°", "checkmark": "✓",
    "langle": "⟨", "rangle": "⟩", "lfloor": "⌊",
    "rfloor": "⌋", "lceil": "⌈", "rceil": "⌉",
    "|": "‖", "{": "{", "}": "}", "%": "%", "$": "$", "#": "#",
    "&": "&", "_": "_", " ": " ", ",": " ", ";": " ",
    "quad": " ", "qquad": "  ", "!": "",
    # function names (rendered upright)
    "sin": "sin", "cos": "cos", "tan": "tan", "cot": "cot", "sec": "sec",
    "csc": "csc", "arcsin": "arcsin", "arccos": "arccos",
    "arctan": "arctan", "sinh": "sinh", "cosh": "cosh", "tanh": "tanh",
    "log": "log", "ln": "ln", "lg": "lg", "exp": "exp", "det": "det",
    "dim": "dim", "ker": "ker", "deg": "deg", "arg": "arg", "gcd": "gcd",
    "min": "min", "max": "max", "sup": "sup", "inf": "inf", "lim": "lim",
    "limsup": "lim sup", "liminf": "lim inf", "Pr": "Pr", "mod": "mod",
}
# function names render as upright text, not italic symbols
FUNCTIONS = {
    "sin", "cos", "tan", "cot", "sec", "csc", "arcsin", "arccos", "arctan",
    "sinh", "cosh", "tanh", "log", "ln", "lg", "exp", "det", "dim", "ker",
    "deg", "arg", "gcd", "min", "max", "sup", "inf", "lim", "limsup",
    "liminf", "Pr", "mod",
}
BIG_OPS = {
    "sum", "prod", "coprod", "int", "iint", "oint", "bigcup", "bigcap",
    "bigoplus", "bigotimes", "bigvee", "bigwedge", "lim", "limsup", "liminf",
}
ACCENTS = {
    "vec": "⃗", "hat": "̂", "bar": "̄", "dot": "̇",
    "ddot": "̈", "tilde": "̃", "overline": "̅",
    "widehat": "̂", "widetilde": "̃",
}
STYLES = {
    "text": "tex-text", "mathrm": "tex-text", "operatorname": "tex-text",
    "mathbf": "tex-bf", "boldsymbol": "tex-bf", "bm": "tex-bf",
    "mathit": "tex-it", "mathbb": "tex-bb", "mathcal": "tex-cal",
    "mathsf": "tex-sf", "mathtt": "tex-tt", "textbf": "tex-bf",
    "textit": "tex-it",
}
MATRIX_ENVS = {
    "matrix": ("", ""), "pmatrix": ("(", ")"), "bmatrix": ("[", "]"),
    "Bmatrix": ("{", "}"), "vmatrix": ("|", "|"), "Vmatrix": ("‖", "‖"),
    "cases": ("{", ""), "align": ("", ""), "aligned": ("", ""),
    "array": ("", ""), "gather": ("", ""),
}


def _esc(s: str) -> str:
    return html.escape(s, quote=False)


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.i = 0
        self.n = len(src)

    # -- tokenization helpers ------------------------------------------

    def peek(self) -> str:
        return self.src[self.i] if self.i < self.n else ""

    def next_char(self) -> str:
        ch = self.src[self.i]
        self.i += 1
        return ch

    def read_command(self) -> str:
        """After the backslash: a letter run, or one non-letter char."""
        start = self.i
        if self.i < self.n and self.src[self.i].isalpha():
            while self.i < self.n and self.src[self.i].isalpha():
                self.i += 1
            return self.src[start : self.i]
        if self.i < self.n:
            self.i += 1
            return self.src[start : self.i]
        return ""

    def skip_ws(self) -> None:
        while self.i < self.n and self.src[self.i] in " \t\n":
            self.i += 1

    def read_group_raw(self) -> str:
        """Raw text of a braced group (for \\text)."""
        self.skip_ws()
        if self.peek() != "{":
            return self.next_char() if self.i < self.n else ""
        self.i += 1
        depth = 1
        start = self.i
        while self.i < self.n:
            ch = self.src[self.i]
            if ch == "\\" and self.i + 1 < self.n:
                self.i += 2
                continue
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    out = self.src[start : self.i]
                    self.i += 1
                    return out
            self.i += 1
        return self.src[start:]

    # -- parsing ---------------------------------------------------------

    def parse_atom(self) -> str:
        """One atom's HTML (group, command, or single char)."""
        self.skip_ws()
        if self.i >= self.n:
            return ""
        ch = self.peek()
        if ch == "{":
            self.i += 1
            return self.parse_until("}")
        if ch == "\\":
            self.i += 1
            return self.command_html(self.read_command())
        self.i += 1
        if ch.isalpha():
            return f'<i class="tex-v">{_esc(ch)}</i>'
        return _esc(ch)

    def command_html(self, cmd: str) -> str:
        if cmd in ("frac", "dfrac", "tfrac", "cfrac"):
            num = self.parse_atom()
            den = self.parse_atom()
            return (
                '<span class="tex-frac"><span class="tex-num">'
                + num
                + '</span><span class="tex-den">'
                + den
                + "</span></span>"
            )
        if cmd == "binom":
            top = self.parse_atom()
            bot = self.parse_atom()
            return (
                '<span class="tex-stretchy">(</span>'
                '<span class="tex-frac tex-binom"><span class="tex-num">'
                + top
                + '</span><span class="tex-den">'
                + bot
                + '</span></span><span class="tex-stretchy">)</span>'
            )
        if cmd == "sqrt":
            self.skip_ws()
            index = ""
            if self.peek() == "[":
                self.i += 1
                depth = 1
                start = self.i
                while self.i < self.n and depth:
                    c = self.src[self.i]
                    if c == "[":
                        depth += 1
                    elif c == "]":
                        depth -= 1
                        if depth == 0:
                            break
                    self.i += 1
                index = render_fragment(self.src[start : self.i])
                self.i += 1  # the closing ]
            arg = self.parse_atom()
            idx_html = (
                f'<span class="tex-root">{index}</span>' if index else ""
            )
            return (
                f'<span class="tex-sqrt">{idx_html}'
                '<span class="tex-surd">√</span>'
                f'<span class="tex-sqrt-arg">{arg}</span></span>'
            )
        if cmd in STYLES:
            # raw bodies render as escaped text: operator names and
            # \mathrm must be upright, and per-letter .tex-v italic
            # would override the parent style class
            raw = cmd in ("text", "textbf", "textit", "mathrm",
                          "operatorname")
            if raw:
                body = _esc(self.read_group_raw())
            else:
                body = self.parse_atom()
            return f'<span class="{STYLES[cmd]}">{body}</span>'
        if cmd in ACCENTS:
            arg = self.parse_atom()
            return (
                f'<span class="tex-accent">{arg}'
                f'<span class="tex-accent-mark">{ACCENTS[cmd]}</span></span>'
            )
        if cmd in ("left", "right"):
            self.skip_ws()
            delim = ""
            if self.peek() == "\\":
                self.i += 1
                delim = SYMBOLS.get(self.read_command(), "")
            elif self.i < self.n:
                delim = self.next_char()
            if delim == ".":
                return ""
            return f'<span class="tex-stretchy">{_esc(delim)}</span>'
        if cmd == "begin":
            return self.parse_environment(self.read_group_raw())
        if cmd == "end":
            self.read_group_raw()  # stray \end: ignore
            return ""
        if cmd in ("displaystyle", "textstyle", "scriptstyle", "limits",
                   "nolimits", "small", "Big", "big", "Bigg", "bigg",
                   "bigl", "bigr", "Bigl", "Bigr", "middle"):
            return ""  # sizing/style no-ops in this subset
        if cmd == "not":
            inner = self.parse_atom()
            return inner + "̸"
        if cmd in SYMBOLS:
            cls = "tex-op" if cmd in BIG_OPS else (
                "tex-fn" if cmd in FUNCTIONS else "tex-sym"
            )
            return f'<span class="{cls}">{_esc(SYMBOLS[cmd])}</span>'
        if cmd == "\\":
            return '<span class="tex-break"></span>'
        # unknown command: degrade to visible literal, never raise
        return f'<span class="tex-unk">\\{_esc(cmd)}</span>'

    def parse_environment(self, env: str) -> str:
        left, right = MATRIX_ENVS.get(env, ("", ""))
        # collect raw body up to the MATCHING \end{env}: a nested
        # same-name environment must not close the outer one
        begin_m = "\\begin{" + env + "}"
        end_m = "\\end{" + env + "}"
        depth, pos = 1, self.i
        end = -1
        while pos < self.n:
            nb = self.src.find(begin_m, pos)
            ne = self.src.find(end_m, pos)
            if ne < 0:
                break
            if 0 <= nb < ne:
                depth += 1
                pos = nb + len(begin_m)
                continue
            depth -= 1
            if depth == 0:
                end = ne
                break
            pos = ne + len(end_m)
        body = self.src[self.i : end if end >= 0 else self.n]
        self.i = (end + len(end_m)) if end >= 0 else self.n
        rows_html = []
        for row in _split_rows(body):
            cells = "".join(
                f'<span class="tex-cell">{render_fragment(c)}</span>'
                for c in _split_cells(row)
            )
            rows_html.append(f'<span class="tex-row">{cells}</span>')
        table = f'<span class="tex-table">{"".join(rows_html)}</span>'
        out = ""
        if left:
            out += f'<span class="tex-stretchy">{_esc(left)}</span>'
        out += table
        if right:
            out += f'<span class="tex-stretchy">{_esc(right)}</span>'
        return out

    def parse_until(self, closer: str | None) -> str:
        """Sequence of atoms (+ script attachment) until ``closer``/EOF."""
        out: list[str] = []
        last_big = False
        while True:
            self.skip_ws()
            if self.i >= self.n:
                break
            ch = self.peek()
            if closer is not None and ch == closer:
                self.i += 1
                break
            if ch in "^_":
                sup = sub = None
                while self.peek() in ("^", "_"):
                    which = self.next_char()
                    part = self.parse_atom()
                    if which == "^":
                        sup = part
                    else:
                        sub = part
                    self.skip_ws()
                base = out.pop() if out else ""
                out.append(_scripts(base, sup, sub, limits=last_big))
                last_big = False
                continue
            before = self.i
            atom = self.parse_atom()
            last_big = 'class="tex-op"' in atom and self.src[
                before : self.i
            ].lstrip().startswith("\\")
            out.append(atom)
        return "".join(out)


def _scripts(base: str, sup: str | None, sub: str | None, limits: bool) -> str:
    cls = "tex-limits" if limits else "tex-scripts"
    parts = [f'<span class="tex-base">{base}</span>']
    if sup is not None:
        parts.append(f'<span class="tex-sup">{sup}</span>')
    if sub is not None:
        parts.append(f'<span class="tex-sub">{sub}</span>')
    return f'<span class="{cls}">{"".join(parts)}</span>'


def _scan_env_delta(s: str, i: int) -> tuple[str, int]:
    r"""At a backslash starting an alpha command, return (consumed_text,
    env_delta): +1 for \begin, -1 for \end, 0 otherwise."""
    j = i + 1
    while j < len(s) and s[j].isalpha():
        j += 1
    name = s[i + 1 : j]
    delta = 1 if name == "begin" else (-1 if name == "end" else 0)
    return s[i:j], delta


def _split_rows(body: str) -> list[str]:
    rows, depth, envd, cur, i = [], 0, 0, [], 0
    while i < len(body):
        ch = body[i]
        # consume backslash escapes as pairs (like _split_cells) so
        # \{ / \} never skew the brace depth; \\ at depth 0 OUTSIDE any
        # nested environment splits — a nested pmatrix's row breaks
        # belong to IT, not to the outer environment
        if ch == "\\" and i + 1 < len(body):
            if body[i + 1].isalpha():
                tok, delta = _scan_env_delta(body, i)
                envd += delta
                cur.append(tok)
                i += len(tok)
                continue
            if depth == 0 and envd == 0 and body[i + 1] == "\\":
                rows.append("".join(cur))
                cur = []
                i += 2
                continue
            cur.append(body[i:i + 2])
            i += 2
            continue
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        cur.append(ch)
        i += 1
    tail = "".join(cur).strip()
    if tail:
        rows.append(tail)
    return rows


def _split_cells(row: str) -> list[str]:
    cells, depth, envd, cur, i = [], 0, 0, [], 0
    while i < len(row):
        ch = row[i]
        if ch == "\\" and i + 1 < len(row):
            if row[i + 1].isalpha():
                tok, delta = _scan_env_delta(row, i)
                envd += delta
                cur.append(tok)
                i += len(tok)
                continue
            cur.append(row[i : i + 2])
            i += 2
            continue
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if depth == 0 and envd == 0 and ch == "&":
            cells.append("".join(cur))
            cur = []
            i += 1
            continue
        cur.append(ch)
        i += 1
    cells.append("".join(cur))
    return cells


def render_fragment(tex: str) -> str:
    """TeX fragment -> HTML (no outer wrapper)."""
    return _Parser(tex).parse_until(None)


def render_math(tex: str, block: bool = False) -> str:
    """TeX -> one HTML element. Never raises on malformed input: any
    internal error degrades to the escaped source text."""
    tag = "div" if block else "span"
    cls = "tex tex-block" if block else "tex"
    try:
        body = render_fragment(tex.strip())
    except Exception:
        body = _esc(tex)
    return f'<{tag} class="{cls}">{body}</{tag}>'
