/*SYMBOLS-BEGIN*/ const TEX_SYMBOLS = {
"alpha": "α",
"beta": "β",
"gamma": "γ",
"delta": "δ",
"epsilon": "ε",
"varepsilon": "ε",
"zeta": "ζ",
"eta": "η",
"theta": "θ",
"vartheta": "ϑ",
"iota": "ι",
"kappa": "κ",
"lambda": "λ",
"mu": "μ",
"nu": "ν",
"xi": "ξ",
"pi": "π",
"varpi": "ϖ",
"rho": "ρ",
"sigma": "σ",
"varsigma": "ς",
"tau": "τ",
"upsilon": "υ",
"phi": "φ",
"varphi": "ϕ",
"chi": "χ",
"psi": "ψ",
"omega": "ω",
"Gamma": "Γ",
"Delta": "Δ",
"Theta": "Θ",
"Lambda": "Λ",
"Xi": "Ξ",
"Pi": "Π",
"Sigma": "Σ",
"Upsilon": "Υ",
"Phi": "Φ",
"Psi": "Ψ",
"Omega": "Ω",
"times": "×",
"div": "÷",
"cdot": "⋅",
"pm": "±",
"mp": "∓",
"ast": "∗",
"star": "⋆",
"circ": "∘",
"bullet": "∙",
"oplus": "⊕",
"ominus": "⊖",
"otimes": "⊗",
"oslash": "⊘",
"odot": "⊙",
"wedge": "∧",
"vee": "∨",
"cap": "∩",
"cup": "∪",
"setminus": "∖",
"leq": "≤",
"le": "≤",
"geq": "≥",
"ge": "≥",
"neq": "≠",
"ne": "≠",
"approx": "≈",
"equiv": "≡",
"sim": "∼",
"simeq": "≃",
"cong": "≅",
"propto": "∝",
"ll": "≪",
"gg": "≫",
"subset": "⊂",
"supset": "⊃",
"subseteq": "⊆",
"supseteq": "⊇",
"in": "∈",
"notin": "∉",
"ni": "∋",
"perp": "⊥",
"parallel": "∥",
"mid": "∣",
"prec": "≺",
"succ": "≻",
"vdash": "⊢",
"models": "⊨",
"to": "→",
"rightarrow": "→",
"leftarrow": "←",
"leftrightarrow": "↔",
"Rightarrow": "⇒",
"Leftarrow": "⇐",
"Leftrightarrow": "⇔",
"iff": "⇔",
"implies": "⟹",
"mapsto": "↦",
"uparrow": "↑",
"downarrow": "↓",
"hookrightarrow": "↪",
"longrightarrow": "⟶",
"rightharpoonup": "⇀",
"sum": "∑",
"prod": "∏",
"coprod": "∐",
"int": "∫",
"iint": "∬",
"oint": "∮",
"bigcup": "⋃",
"bigcap": "⋂",
"bigoplus": "⨁",
"bigotimes": "⨂",
"bigvee": "⋁",
"bigwedge": "⋀",
"infty": "∞",
"partial": "∂",
"nabla": "∇",
"forall": "∀",
"exists": "∃",
"nexists": "∄",
"emptyset": "∅",
"varnothing": "∅",
"neg": "¬",
"lnot": "¬",
"land": "∧",
"lor": "∨",
"angle": "∠",
"triangle": "△",
"square": "□",
"hbar": "ℏ",
"ell": "ℓ",
"Re": "ℜ",
"Im": "ℑ",
"aleph": "ℵ",
"wp": "℘",
"prime": "′",
"dots": "…",
"ldots": "…",
"cdots": "⋯",
"vdots": "⋮",
"ddots": "⋱",
"therefore": "∴",
"because": "∵",
"degree": "°",
"checkmark": "✓",
"langle": "⟨",
"rangle": "⟩",
"lfloor": "⌊",
"rfloor": "⌋",
"lceil": "⌈",
"rceil": "⌉",
"|": "‖",
"{": "{",
"}": "}",
"%": "%",
"$": "$",
"#": "#",
"&": "&",
"_": "_",
" ": " ",
",": " ",
";": " ",
"quad": " ",
"qquad": "  ",
"!": "",
"sin": "sin",
"cos": "cos",
"tan": "tan",
"cot": "cot",
"sec": "sec",
"csc": "csc",
"arcsin": "arcsin",
"arccos": "arccos",
"arctan": "arctan",
"sinh": "sinh",
"cosh": "cosh",
"tanh": "tanh",
"log": "log",
"ln": "ln",
"lg": "lg",
"exp": "exp",
"det": "det",
"dim": "dim",
"ker": "ker",
"deg": "deg",
"arg": "arg",
"gcd": "gcd",
"min": "min",
"max": "max",
"sup": "sup",
"inf": "inf",
"lim": "lim",
"limsup": "lim sup",
"liminf": "lim inf",
"Pr": "Pr",
"mod": "mod"
}; /*SYMBOLS-END*/
/*FUNCTIONS-BEGIN*/ const TEX_FUNCTIONS = ["Pr", "arccos", "arcsin", "arctan", "arg", "cos", "cosh", "cot", "csc", "deg", "det", "dim", "exp", "gcd", "inf", "ker", "lg", "lim", "liminf", "limsup", "ln", "log", "max", "min", "mod", "sec", "sin", "sinh", "sup", "tan", "tanh"]; /*FUNCTIONS-END*/
/*BIG_OPS-BEGIN*/ const TEX_BIG_OPS = ["bigcap", "bigcup", "bigoplus", "bigotimes", "bigvee", "bigwedge", "coprod", "iint", "int", "lim", "liminf", "limsup", "oint", "prod", "sum"]; /*BIG_OPS-END*/
/*ACCENTS-BEGIN*/ const TEX_ACCENTS = {"vec": "⃗", "hat": "̂", "bar": "̄", "dot": "̇", "ddot": "̈", "tilde": "̃", "overline": "̅", "widehat": "̂", "widetilde": "̃"}; /*ACCENTS-END*/
/*STYLES-BEGIN*/ const TEX_STYLES = {"text": "tex-text", "mathrm": "tex-text", "operatorname": "tex-text", "mathbf": "tex-bf", "boldsymbol": "tex-bf", "bm": "tex-bf", "mathit": "tex-it", "mathbb": "tex-bb", "mathcal": "tex-cal", "mathsf": "tex-sf", "mathtt": "tex-tt", "textbf": "tex-bf", "textit": "tex-it"}; /*STYLES-END*/
/*MATRIX_ENVS-BEGIN*/ const TEX_MATRIX_ENVS = {"matrix": ["", ""], "pmatrix": ["(", ")"], "bmatrix": ["[", "]"], "Bmatrix": ["{", "}"], "vmatrix": ["|", "|"], "Vmatrix": ["‖", "‖"], "cases": ["{", ""], "align": ["", ""], "aligned": ["", ""], "array": ["", ""], "gather": ["", ""]}; /*MATRIX_ENVS-END*/
/* TeX-math -> HTML typesetter: line-faithful JS port of the canonical
   Python implementation in outline_rag_tpu/utils/texmath.py (which is
   the unit-tested source of truth — tests/test_texmath.py also verifies
   the tables above stay byte-identical). Replaces the reference's CDN
   KaTeX (reference app/static/js/core.js:227-244) with a zero-dependency
   subset renderer. Unknown commands degrade to literals; never throws. */

const TEX_FN_SET = new Set(TEX_FUNCTIONS);
const TEX_OP_SET = new Set(TEX_BIG_OPS);

function texEsc(s) {
  return String(s).replace(/&/g, "&amp;").replace(/</g, "&lt;").replace(/>/g, "&gt;");
}

class TexParser {
  constructor(src) { this.src = src; this.i = 0; this.n = src.length; }

  peek() { return this.i < this.n ? this.src[this.i] : ""; }
  nextChar() { return this.src[this.i++]; }

  readCommand() {
    const start = this.i;
    if (this.i < this.n && /[a-zA-Z]/.test(this.src[this.i])) {
      while (this.i < this.n && /[a-zA-Z]/.test(this.src[this.i])) this.i++;
      return this.src.slice(start, this.i);
    }
    if (this.i < this.n) { this.i++; return this.src.slice(start, this.i); }
    return "";
  }

  skipWs() { while (this.i < this.n && " \t\n".includes(this.src[this.i])) this.i++; }

  readGroupRaw() {
    this.skipWs();
    if (this.peek() !== "{") return this.i < this.n ? this.nextChar() : "";
    this.i++;
    let depth = 1; const start = this.i;
    while (this.i < this.n) {
      const ch = this.src[this.i];
      if (ch === "\\" && this.i + 1 < this.n) { this.i += 2; continue; }
      if (ch === "{") depth++;
      else if (ch === "}") {
        depth--;
        if (depth === 0) { const out = this.src.slice(start, this.i); this.i++; return out; }
      }
      this.i++;
    }
    return this.src.slice(start);
  }

  parseAtom() {
    this.skipWs();
    if (this.i >= this.n) return "";
    const ch = this.peek();
    if (ch === "{") { this.i++; return this.parseUntil("}"); }
    if (ch === "\\") { this.i++; return this.commandHtml(this.readCommand()); }
    this.i++;
    if (/[a-zA-Z]/.test(ch)) return '<i class="tex-v">' + texEsc(ch) + "</i>";
    return texEsc(ch);
  }

  commandHtml(cmd) {
    if (["frac", "dfrac", "tfrac", "cfrac"].includes(cmd)) {
      const num = this.parseAtom(); const den = this.parseAtom();
      return '<span class="tex-frac"><span class="tex-num">' + num +
        '</span><span class="tex-den">' + den + "</span></span>";
    }
    if (cmd === "binom") {
      const top = this.parseAtom(); const bot = this.parseAtom();
      return '<span class="tex-stretchy">(</span>' +
        '<span class="tex-frac tex-binom"><span class="tex-num">' + top +
        '</span><span class="tex-den">' + bot +
        '</span></span><span class="tex-stretchy">)</span>';
    }
    if (cmd === "sqrt") {
      this.skipWs();
      let index = "";
      if (this.peek() === "[") {
        this.i++;
        let depth = 1; const start = this.i;
        while (this.i < this.n && depth) {
          const c = this.src[this.i];
          if (c === "[") depth++;
          else if (c === "]") { depth--; if (depth === 0) break; }
          this.i++;
        }
        index = texFragment(this.src.slice(start, this.i));
        this.i++;
      }
      const arg = this.parseAtom();
      const idxHtml = index ? '<span class="tex-root">' + index + "</span>" : "";
      return '<span class="tex-sqrt">' + idxHtml +
        '<span class="tex-surd">√</span>' +
        '<span class="tex-sqrt-arg">' + arg + "</span></span>";
    }
    if (cmd in TEX_STYLES) {
      // raw bodies render as escaped text: operator names and \mathrm
      // must be upright (per-letter .tex-v italic would override the
      // parent style class)
      const raw = ["text", "textbf", "textit", "mathrm", "operatorname"].includes(cmd);
      const body = raw ? texEsc(this.readGroupRaw()) : this.parseAtom();
      return '<span class="' + TEX_STYLES[cmd] + '">' + body + "</span>";
    }
    if (cmd in TEX_ACCENTS) {
      const arg = this.parseAtom();
      return '<span class="tex-accent">' + arg +
        '<span class="tex-accent-mark">' + TEX_ACCENTS[cmd] + "</span></span>";
    }
    if (cmd === "left" || cmd === "right") {
      this.skipWs();
      let delim = "";
      if (this.peek() === "\\") { this.i++; delim = TEX_SYMBOLS[this.readCommand()] || ""; }
      else if (this.i < this.n) delim = this.nextChar();
      if (delim === ".") return "";
      return '<span class="tex-stretchy">' + texEsc(delim) + "</span>";
    }
    if (cmd === "begin") return this.parseEnvironment(this.readGroupRaw());
    if (cmd === "end") { this.readGroupRaw(); return ""; }
    if (["displaystyle", "textstyle", "scriptstyle", "limits", "nolimits",
         "small", "Big", "big", "Bigg", "bigg", "bigl", "bigr", "Bigl",
         "Bigr", "middle"].includes(cmd)) return "";
    if (cmd === "not") { return this.parseAtom() + "̸"; }
    if (cmd in TEX_SYMBOLS) {
      const cls = TEX_OP_SET.has(cmd) ? "tex-op" : (TEX_FN_SET.has(cmd) ? "tex-fn" : "tex-sym");
      return '<span class="' + cls + '">' + texEsc(TEX_SYMBOLS[cmd]) + "</span>";
    }
    if (cmd === "\\") return '<span class="tex-break"></span>';
    return '<span class="tex-unk">\\' + texEsc(cmd) + "</span>";
  }

  parseEnvironment(env) {
    const lr = TEX_MATRIX_ENVS[env] || ["", ""];
    // find the MATCHING \end{env}: a nested same-name environment must
    // not close the outer one
    const beginM = "\\begin{" + env + "}";
    const endM = "\\end{" + env + "}";
    let depth = 1, pos = this.i, end = -1;
    while (pos < this.n) {
      const nb = this.src.indexOf(beginM, pos);
      const ne = this.src.indexOf(endM, pos);
      if (ne < 0) break;
      if (nb >= 0 && nb < ne) { depth++; pos = nb + beginM.length; continue; }
      depth--;
      if (depth === 0) { end = ne; break; }
      pos = ne + endM.length;
    }
    const body = this.src.slice(this.i, end >= 0 ? end : this.n);
    this.i = end >= 0 ? end + endM.length : this.n;
    const rowsHtml = texSplitRows(body).map((row) => {
      const cells = texSplitCells(row)
        .map((c) => '<span class="tex-cell">' + texFragment(c) + "</span>")
        .join("");
      return '<span class="tex-row">' + cells + "</span>";
    });
    let out = "";
    if (lr[0]) out += '<span class="tex-stretchy">' + texEsc(lr[0]) + "</span>";
    out += '<span class="tex-table">' + rowsHtml.join("") + "</span>";
    if (lr[1]) out += '<span class="tex-stretchy">' + texEsc(lr[1]) + "</span>";
    return out;
  }

  parseUntil(closer) {
    const out = [];
    let lastBig = false;
    for (;;) {
      this.skipWs();
      if (this.i >= this.n) break;
      const ch = this.peek();
      if (closer !== null && ch === closer) { this.i++; break; }
      if (ch === "^" || ch === "_") {
        let sup = null, sub = null;
        while (this.peek() === "^" || this.peek() === "_") {
          const which = this.nextChar();
          const part = this.parseAtom();
          if (which === "^") sup = part; else sub = part;
          this.skipWs();
        }
        const base = out.length ? out.pop() : "";
        out.push(texScripts(base, sup, sub, lastBig));
        lastBig = false;
        continue;
      }
      const before = this.i;
      const atom = this.parseAtom();
      lastBig = atom.includes('class="tex-op"') &&
        this.src.slice(before, this.i).trimStart().startsWith("\\");
      out.push(atom);
    }
    return out.join("");
  }
}

function texScripts(base, sup, sub, limits) {
  const cls = limits ? "tex-limits" : "tex-scripts";
  let s = '<span class="' + cls + '"><span class="tex-base">' + base + "</span>";
  if (sup !== null) s += '<span class="tex-sup">' + sup + "</span>";
  if (sub !== null) s += '<span class="tex-sub">' + sub + "</span>";
  return s + "</span>";
}

function texScanEnvDelta(s, i) {
  // at a backslash starting an alpha command: [consumedText, envDelta]
  let j = i + 1;
  while (j < s.length && /[a-zA-Z]/.test(s[j])) j++;
  const name = s.slice(i + 1, j);
  const delta = name === "begin" ? 1 : (name === "end" ? -1 : 0);
  return [s.slice(i, j), delta];
}

function texSplitRows(body) {
  const rows = []; let depth = 0, envd = 0, cur = "", i = 0;
  while (i < body.length) {
    const ch = body[i];
    // consume backslash escapes as pairs (like texSplitCells) so
    // \{ / \} never skew the brace depth; \\ at depth 0 OUTSIDE any
    // nested environment splits — a nested pmatrix's row breaks
    // belong to IT, not to the outer environment
    if (ch === "\\" && i + 1 < body.length) {
      if (/[a-zA-Z]/.test(body[i + 1])) {
        const [tok, delta] = texScanEnvDelta(body, i);
        envd += delta; cur += tok; i += tok.length; continue;
      }
      if (depth === 0 && envd === 0 && body[i + 1] === "\\") {
        rows.push(cur); cur = ""; i += 2; continue;
      }
      cur += body.slice(i, i + 2); i += 2; continue;
    }
    if (ch === "{") depth++;
    else if (ch === "}") depth--;
    cur += ch; i++;
  }
  if (cur.trim()) rows.push(cur);
  return rows;
}

function texSplitCells(row) {
  const cells = []; let depth = 0, envd = 0, cur = "", i = 0;
  while (i < row.length) {
    const ch = row[i];
    if (ch === "\\" && i + 1 < row.length) {
      if (/[a-zA-Z]/.test(row[i + 1])) {
        const [tok, delta] = texScanEnvDelta(row, i);
        envd += delta; cur += tok; i += tok.length; continue;
      }
      cur += row.slice(i, i + 2); i += 2; continue;
    }
    if (ch === "{") depth++;
    else if (ch === "}") depth--;
    if (depth === 0 && envd === 0 && ch === "&") { cells.push(cur); cur = ""; i++; continue; }
    cur += ch; i++;
  }
  cells.push(cur);
  return cells;
}

function texFragment(tex) {
  return new TexParser(tex).parseUntil(null);
}

function texToHtml(tex, block) {
  const tag = block ? "div" : "span";
  const cls = block ? "tex tex-block" : "tex";
  let body;
  try { body = texFragment(String(tex).trim()); }
  catch (e) { body = texEsc(tex); }
  return "<" + tag + ' class="' + cls + '">' + body + "</" + tag + ">";
}
