/* Chat SPA for the TPU-native Outline RAG framework.
 *
 * Covers the user-visible behaviors of the reference frontend
 * (conversation CRUD, SSE streaming with thinking blocks, [SourcesMap]
 * citation linkification, refresh-status polling, edit-and-resubmit) in
 * dependency-free vanilla JS.
 */
"use strict";

const API = "/chat/api";
const $ = (sel) => document.querySelector(sel);

const state = {
  me: null,
  models: [],
  conversations: [],
  current: null,
  streaming: false,
  abort: null,
  params: { temperature: null, top_p: null }, // null -> model defaults
};

// ---------- tiny helpers ----------

async function api(path, opts = {}) {
  const resp = await fetch(API + path, {
    headers: { "content-type": "application/json" },
    credentials: "same-origin",
    ...opts,
  });
  if (resp.status === 401) {
    window.location.href = "/chat/login";
    throw new Error("unauthorized");
  }
  return resp;
}

function esc(s) {
  /* quotes included: esc() output is interpolated into attribute
   * values (href/title/src) — unescaped quotes break out of the
   * attribute and smuggle live event handlers */
  return s.replace(/&/g, "&amp;").replace(/</g, "&lt;").replace(/>/g, "&gt;")
    .replace(/"/g, "&quot;").replace(/'/g, "&#39;");
}

/* ---------- model/provider icons (reference: per-model brand images,
 * core.js:80-92 + static/img). First-party equivalent: deterministic
 * inline-SVG monograms — the provider prefix picks a stable hue and the
 * initial letter, so every model gets a distinct avatar with zero
 * binary assets and zero CDN fetches. */

const APP_ICON =
  '<svg class="app-icon" viewBox="0 0 64 64" aria-hidden="true">' +
  '<rect x="4" y="4" width="56" height="56" rx="14" fill="var(--accent)"/>' +
  '<circle cx="28" cy="27" r="11.5" fill="none" stroke="#fff" stroke-width="5"/>' +
  '<line x1="37" y1="36" x2="47" y2="46" stroke="#fff" stroke-width="6" stroke-linecap="round"/>' +
  "</svg>";

function modelIcon(modelId) {
  /* operator-supplied icon URL in the catalog wins (reference
   * modelConf.icon, core.js:86); otherwise a generated monogram */
  const conf = state.models.find((m) => m.id === modelId);
  if (conf && conf.icon) {
    return `<img class="model-icon" src="${safeHref(conf.icon)}" alt=""/>`;
  }
  const provider = ((modelId || "").split(/[\/@]/)[0] || "model").toLowerCase();
  let h = 0;
  for (let i = 0; i < provider.length; i++) h = (h * 31 + provider.charCodeAt(i)) >>> 0;
  const hue = h % 360;
  const letter = esc(provider[0].toUpperCase());
  return (
    `<svg class="model-icon" viewBox="0 0 24 24" aria-hidden="true">` +
    `<circle cx="12" cy="12" r="11" fill="hsl(${hue} 55% 45%)"/>` +
    `<text x="12" y="16.4" text-anchor="middle" font-size="12.5" font-weight="700" ` +
    `fill="#fff" font-family="system-ui,sans-serif">${letter}</text></svg>`
  );
}

function syncModelIcon() {
  const badge = $("#model-icon");
  if (badge) badge.innerHTML = modelIcon($("#model-picker").value);
}

/* ---------- in-app dialogs + toasts (reference: Shoelace dialogs,
 * core.js:60-150) — promise-based modal overlay, no native prompt(). */

function _dialog(message, { input = null, confirmLabel = "OK", danger = false } = {}) {
  return new Promise((resolve) => {
    const overlay = document.createElement("div");
    overlay.className = "modal-overlay";
    const box = document.createElement("div");
    box.className = "modal";
    const msg = document.createElement("p");
    msg.className = "modal-msg";
    msg.textContent = message;
    box.appendChild(msg);
    let field = null;
    if (input !== null) {
      field = document.createElement("input");
      field.className = "modal-input";
      field.value = input;
      box.appendChild(field);
    }
    const row = document.createElement("div");
    row.className = "modal-actions";
    const cancel = document.createElement("button");
    cancel.className = "modal-btn";
    cancel.textContent = "Cancel";
    const ok = document.createElement("button");
    ok.className = "modal-btn primary" + (danger ? " danger" : "");
    ok.textContent = confirmLabel;
    row.append(cancel, ok);
    box.appendChild(row);
    overlay.appendChild(box);
    document.body.appendChild(overlay);
    const close = (value) => {
      overlay.remove();
      document.removeEventListener("keydown", onKey);
      resolve(value);
    };
    const onKey = (e) => {
      if (e.key === "Escape") close(null);
      if (e.key === "Enter") {
        if (document.activeElement === cancel) {
          close(null);  // Enter activates the focused Cancel button
        } else if (input === null || document.activeElement === field) {
          close(input !== null ? field.value : true);
        }
      }
    };
    document.addEventListener("keydown", onKey);
    cancel.onclick = () => close(null);
    ok.onclick = () => close(input !== null ? field.value : true);
    overlay.onclick = (e) => { if (e.target === overlay) close(null); };
    (field || ok).focus();
    if (field) field.select();
  });
}

function uiConfirm(message, confirmLabel = "Delete") {
  return _dialog(message, { confirmLabel, danger: true }).then((v) => v === true);
}

function uiPrompt(message, initial = "") {
  return _dialog(message, { input: initial, confirmLabel: "Save" });
}

function toast(message, kind = "info", ms = 3200) {
  let holder = $("#toasts");
  if (!holder) {
    holder = document.createElement("div");
    holder.id = "toasts";
    document.body.appendChild(holder);
  }
  const t = document.createElement("div");
  t.className = "toast " + kind;
  t.textContent = message;
  holder.appendChild(t);
  setTimeout(() => { t.classList.add("out"); setTimeout(() => t.remove(), 300); }, ms);
}

/* ---------- markdown pipeline (reference: core.js parseMarkdownSafe) ----
 * LaTeX spans are masked BEFORE markdown so underscores/asterisks inside
 * math never get mangled, then restored into styled math elements. */

const HASH_COMMENT_LANGS = new Set(["py", "python", "sh", "bash", "shell", "yaml", "yml", "rb", "ruby", "toml"]);
const SLASH_COMMENT_LANGS = new Set(["js", "javascript", "ts", "typescript", "c", "cpp", "c++", "java", "go", "rust", "rs", "json5", "css", "kotlin", "swift", "scala", "proto"]);
const KEYWORDS = new Set((
  "def class return if elif else for while in not and or import from as with try except finally lambda yield pass break continue raise global nonlocal assert del True False None async await " +
  "function var let const new delete typeof instanceof this null undefined true false switch case default do throw catch extends super static get set export " +
  "int long float double char bool void struct enum union template typename public private protected virtual override namespace using sizeof nullptr " +
  "fn mut impl trait pub use mod match crate dyn ref where loop unsafe type " +
  "func go defer chan select package interface map range " +
  "SELECT FROM WHERE INSERT INTO UPDATE DELETE CREATE TABLE INDEX JOIN LEFT RIGHT INNER OUTER ON GROUP BY ORDER LIMIT OFFSET VALUES SET AND OR NOT NULL PRIMARY KEY DISTINCT AS select from where insert into update delete create table index join left right inner outer on group by order limit offset values set primary key distinct"
).split(/\s+/));

/* token-at-a-time highlighter: strings, comments, numbers, keywords */
function highlightCode(code, lang) {
  lang = (lang || "").toLowerCase();
  const parts = [];
  const re = /("(?:[^"\\\n]|\\.)*"|'(?:[^'\\\n]|\\.)*'|`(?:[^`\\]|\\.)*`)|(#[^\n]*|\/\/[^\n]*|\/\*[\s\S]*?\*\/|--[^\n]*)|(\b\d(?:[\w.])*\b)|([A-Za-z_][A-Za-z0-9_]*)/g;
  let last = 0, m;
  while ((m = re.exec(code))) {
    parts.push(esc(code.slice(last, m.index)));
    last = m.index + m[0].length;
    const tok = esc(m[0]);
    if (m[1]) parts.push(`<span class="tok-str">${tok}</span>`);
    else if (m[2]) {
      const ok =
        (m[0][0] === "#" && (HASH_COMMENT_LANGS.has(lang) || !lang)) ||
        (m[0][0] === "/" && (SLASH_COMMENT_LANGS.has(lang) || !lang)) ||
        (m[0][0] === "-" && (lang === "sql" || lang === "lua"));
      parts.push(ok ? `<span class="tok-com">${tok}</span>` : tok);
    } else if (m[3]) parts.push(`<span class="tok-num">${tok}</span>`);
    else if (m[4]) parts.push(KEYWORDS.has(m[0]) ? `<span class="tok-kw">${tok}</span>` : tok);
  }
  parts.push(esc(code.slice(last)));
  return parts.join("");
}

function safeHref(url) {
  const u = (url || "").trim();
  if (/^(https?:\/\/|\/|#|mailto:)/i.test(u)) return esc(u);
  return "#";
}

function renderInline(text) {
  /* input is already HTML-escaped */
  return text
    .replace(/`([^`]+)`/g, (m, c) => `<code>${c}</code>`)
    .replace(/\[([^\]]+)\]\(([^)\s]+)\)/g, (m, t, u) => `<a href="${safeHref(u)}" target="_blank" rel="noopener">${t}</a>`)
    .replace(/\*\*([^*]+)\*\*/g, "<strong>$1</strong>")
    .replace(/~~([^~]+)~~/g, "<del>$1</del>")
    .replace(/(^|[\s(])\*([^*\s][^*]*)\*/g, "$1<em>$2</em>")
    .replace(/(^|[\s(])_([^_\s][^_]*)_/g, "$1<em>$2</em>");
}

function renderBlocks(text) {
  const lines = text.split("\n");
  let html = "", i = 0;
  const flushPara = (buf) => {
    if (buf.length) html += "<p>" + renderInline(buf.join("<br/>")) + "</p>";
    buf.length = 0;
  };
  const para = [];
  while (i < lines.length) {
    const line = lines[i];
    let m;
    if ((m = line.match(/^(#{1,6})\s+(.*)$/))) {
      flushPara(para);
      const lvl = m[1].length;
      html += `<h${lvl}>` + renderInline(m[2]) + `</h${lvl}>`;
      i++;
    } else if (/^(\s*)([-*+]|\d+[.)])\s+/.test(line)) {
      flushPara(para);
      /* indentation-based nesting: deeper items open a sublist inside
       * the previous <li> (reference uses marked's full list parser) */
      const listAt = (indent, depth) => {
        const first = lines[i].match(/^(\s*)([-*+]|\d+[.)])\s+/);
        const tag = /\d/.test(first[2]) ? "ol" : "ul";
        let out = `<${tag}>`, liOpen = false;
        while (i < lines.length) {
          const m2 = lines[i].match(/^(\s*)([-*+]|\d+[.)])\s+(.*)$/);
          if (!m2) break;
          const ind = m2[1].length;
          if (ind < indent) break;
          /* depth bound: degenerate ever-deeper input renders flat at
           * the cap instead of overflowing the call stack */
          if (ind > indent && depth < 8) { out += listAt(ind, depth + 1); continue; }
          if (liOpen) out += "</li>";
          out += "<li>" + renderInline(m2[3]);
          liOpen = true;
          i++;
        }
        if (liOpen) out += "</li>";
        return out + `</${tag}>`;
      };
      html += listAt(line.match(/^(\s*)/)[1].length, 0);
    } else if (/^\s*>\s?/.test(line)) {
      flushPara(para);
      const quote = [];
      while (i < lines.length && /^\s*>\s?/.test(lines[i])) {
        quote.push(lines[i].replace(/^\s*>\s?/, ""));
        i++;
      }
      html += "<blockquote>" + renderBlocks(quote.join("\n")) + "</blockquote>";
    } else if (/^\s*(---+|\*\*\*+|___+)\s*$/.test(line)) {
      flushPara(para);
      html += "<hr/>";
      i++;
    } else if (
      line.includes("|") && i + 1 < lines.length &&
      /^\s*\|?[\s:|-]+\|[\s:|-]*$/.test(lines[i + 1])
    ) {
      flushPara(para);
      const cells = (l) => l.replace(/^\s*\|/, "").replace(/\|\s*$/, "").split("|").map((c) => renderInline(c.trim()));
      html += "<table><thead><tr>" + cells(line).map((c) => `<th>${c}</th>`).join("") + "</tr></thead><tbody>";
      i += 2;
      while (i < lines.length && lines[i].includes("|") && lines[i].trim()) {
        html += "<tr>" + cells(lines[i]).map((c) => `<td>${c}</td>`).join("") + "</tr>";
        i++;
      }
      html += "</tbody></table>";
    } else if (!line.trim()) {
      flushPara(para);
      i++;
    } else {
      para.push(line);
      i++;
    }
  }
  flushPara(para);
  return html;
}

function renderMarkdown(text) {
  /* 1. mask LaTeX so markdown can't corrupt it */
  const math = [];
  const MASK = (tex, block) => {
    math.push({ tex, block });
    return "\x00M" + (math.length - 1) + "\x00";
  };
  text = text
    .replace(/\$\$([\s\S]+?)\$\$/g, (m, tex) => MASK(tex, true))
    .replace(/\\\[([\s\S]+?)\\\]/g, (m, tex) => MASK(tex, true))
    .replace(/\\\(([\s\S]+?)\\\)/g, (m, tex) => MASK(tex, false))
    /* Pandoc-style heuristic so currency ("between $5 and $10") is left
       alone: no space adjacent to either delimiter, closing $ not
       followed by a digit. */
    .replace(/\$(?!\s)([^$\n]*[^$\s])\$(?!\d)/g, (m, tex) => MASK(tex, false));

  /* 2. fenced code out first, then block markdown on the rest */
  const blocks = text.split(/```/);
  let html = "";
  blocks.forEach((blk, i) => {
    if (i % 2 === 1) {
      const lang = (blk.match(/^([A-Za-z0-9+#-]*)\n/) || [])[1] || "";
      const code = blk.replace(/^[A-Za-z0-9+#-]*\n/, "");
      html += `<pre><code class="lang-${esc(lang)}">` + highlightCode(code, lang) + "</code></pre>";
    } else {
      html += renderBlocks(esc(blk));
    }
  });

  /* 3. restore math through the typesetter (tex.js, the KaTeX-class
     subset renderer; styled-source fallback if it failed to load) */
  return html.replace(/\x00M(\d+)\x00/g, (m, n) => {
    const item = math[+n];
    if (!item) return "";
    if (typeof texToHtml === "function") return texToHtml(item.tex, item.block);
    const tag = item.block ? "div" : "span";
    return `<${tag} class="math${item.block ? " math-block" : ""}">${esc(item.tex.trim())}</${tag}>`;
  });
}

/* kept as an alias: user bubbles + thinking blocks share the renderer */
const renderMarkdownLite = renderMarkdown;

/* Tolerant citation linkifier (parity with the reference's
 * looseCitationRegex walk, app/static/js/app.js:55-109): models and
 * non-English prompt overrides emit citations in many shapes —
 * [source 3], [来源 3], 【参考 1, 2】, (Source 4), bare [3] — so any
 * bracket family around a token containing digits linkifies, one
 * anchor per number that exists in the sources map; tokens with no
 * mapped number stay verbatim. We render markdown to an HTML string
 * (not a DOM), so the reference's skip-code TreeWalker becomes a
 * segment split: <pre>/<code> bodies and tag internals pass through
 * untouched. */
function linkifyCitations(html, sources) {
  const loose = /[\[【(]\s*([^\]】)]*?(?:来源|参考|source|\d+)[^\]】)]*?)[\]】)]/gi;
  const seg = /(<pre[\s\S]*?<\/pre>|<code[\s\S]*?<\/code>|<[^>]*>)/g;
  return html
    .split(seg)
    .map((part, i) => {
      if (i % 2 === 1) return part; // tags + code segments
      return part.replace(loose, (m, inner) => {
        const nums = inner.match(/\d+/g);
        if (!nums) return m;
        const valid = nums.filter((n) => sources[n]);
        if (!valid.length) return m;
        return valid
          .map((n) => {
            const src = sources[n];
            return `<a class="citation" href="${safeHref(src.url)}" target="_blank" title="${esc(src.title || "")}">[${n}]</a>`;
          })
          .join("");
      });
    })
    .join("");
}

/* Extract hidden sources map + thinking block, linkify citations. */
function renderAssistant(content) {
  let thinking = null;
  const tOpen = "\n<!--thinking-->\n", tClose = "\n<!--/thinking-->\n";
  if (content.includes(tOpen) && content.includes(tClose)) {
    const pre = content.split(tOpen)[0];
    const rest = content.split(tOpen)[1];
    thinking = rest.split(tClose)[0];
    content = pre + rest.split(tClose).slice(1).join(tClose);
  }
  let sources = null;
  content = content
    .split("\n")
    .filter((line) => {
      if (line.startsWith("[SourcesMap]:")) {
        try { sources = JSON.parse(line.slice(13).trim()); } catch (e) {}
        return false;
      }
      return true;
    })
    .join("\n");
  let html = renderMarkdownLite(content.trim());
  if (sources) html = linkifyCitations(html, sources);
  let out = "";
  if (thinking) {
    out += `<details class="thinking"><summary>thinking</summary><div>${renderMarkdownLite(thinking.trim())}</div></details>`;
  }
  return out + html;
}

// ---------- conversations ----------

async function loadMe() {
  const resp = await api("/me");
  const data = await resp.json();
  state.me = data.user;
  state.models = data.models;
  const picker = $("#model-picker");
  picker.innerHTML = "";
  data.models.forEach((m) => {
    const opt = document.createElement("option");
    opt.value = m.id;
    opt.textContent = m.label;
    picker.appendChild(opt);
  });
  syncModelIcon();
  buildAccountMenu();
}

/* avatar + account dropdown (reference topbar.css .avatar/.menu): the
 * user's initial in a circle; the menu carries identity, a theme
 * radio group, and sign-out */
function buildAccountMenu() {
  const av = $("#avatar");
  const menu = $("#account-menu");
  if (!av || !menu) return;
  const name = (state.me?.name || "").trim();
  const pic = safeHref(state.me?.picture || "");
  if (pic && pic !== "#") {
    av.innerHTML = `<img class="avatar-img" src="${pic}" alt="">`;
  } else {
    av.textContent = (name || "?").slice(0, 1).toUpperCase();
  }
  av.title = name || "Account";
  menu.innerHTML = "";
  menu.onclick = (e) => e.stopPropagation();
  const label = document.createElement("div");
  label.className = "menu-label";
  label.textContent = name || "Signed in";
  menu.appendChild(label);
  if (state.me?.email) {
    const mail = document.createElement("div");
    mail.className = "menu-sub";
    mail.textContent = state.me.email;
    menu.appendChild(mail);
  }
  const div1 = document.createElement("div");
  div1.className = "menu-divider";
  menu.appendChild(div1);
  const section = document.createElement("div");
  section.className = "menu-label";
  section.textContent = "Theme";
  menu.appendChild(section);
  ["dark", "light", "system"].forEach((choice) => {
    const r = document.createElement("button");
    r.className = "menu-radio";
    r.dataset.choice = choice;
    r.textContent = choice[0].toUpperCase() + choice.slice(1);
    r.onclick = () => {
      applyTheme(choice);
      syncThemeRadios();
    };
    menu.appendChild(r);
  });
  const div2 = document.createElement("div");
  div2.className = "menu-divider";
  menu.appendChild(div2);
  const out = document.createElement("a");
  out.setAttribute("href", "/chat/logout");
  out.textContent = "Sign out";
  menu.appendChild(out);
  syncThemeRadios();
  av.onclick = (e) => {
    e.stopPropagation();
    const open = menu.classList.contains("visible");
    closePopovers();
    if (!open) menu.classList.add("visible");
  };
}

function syncThemeRadios() {
  let choice = "dark";
  try { choice = localStorage.getItem("theme") || "dark"; } catch (e) {}
  document.querySelectorAll("#account-menu .menu-radio").forEach((r) => {
    r.classList.toggle("active", r.dataset.choice === choice);
  });
}

async function loadConversations() {
  const resp = await api("/conversations");
  state.conversations = (await resp.json()).conversations;
  const ul = $("#conv-list");
  ul.innerHTML = "";
  state.conversations.forEach((c) => {
    const li = document.createElement("li");
    li.dataset.id = c.id;
    li.className = c.id === state.current ? "active" : "";
    const title = document.createElement("span");
    title.textContent = c.title || "Untitled";
    title.onclick = () => selectConversation(c.id);
    /* per-conversation "⋯" menu: one trigger opening a Rename/Delete
     * popover (reference sidebar.css conv-menu + conv-menu-pop) instead
     * of a row of always-present action buttons; items are real
     * <button>s so keyboard users can Tab + Enter them */
    const menuBtn = document.createElement("button");
    menuBtn.className = "conv-menu";
    menuBtn.textContent = "⋯";
    menuBtn.title = "Conversation actions";
    const pop = document.createElement("div");
    pop.className = "conv-menu-pop";
    pop.onclick = (e) => e.stopPropagation();
    const rename = document.createElement("button");
    rename.textContent = "Rename";
    rename.onclick = async () => {
      closePopovers();
      const t = await uiPrompt("Rename conversation", c.title);
      if (t) {
        await api(`/conversations/${c.id}`, { method: "PUT", body: JSON.stringify({ title: t }) });
        toast("Conversation renamed");
        loadConversations();
      }
    };
    const del = document.createElement("button");
    del.className = "danger";
    del.textContent = "Delete";
    del.onclick = async () => {
      closePopovers();
      if (!(await uiConfirm("Delete this conversation? This cannot be undone."))) return;
      await api(`/conversations/${c.id}`, { method: "DELETE" });
      if (state.current === c.id) { state.current = null; $("#messages").innerHTML = ""; }
      toast("Conversation deleted");
      loadConversations();
    };
    pop.append(rename, del);
    menuBtn.onclick = (e) => {
      e.stopPropagation();
      const open = pop.classList.contains("visible");
      closePopovers();
      if (open) return;
      /* real browsers: fixed-position at the trigger so the popover is
       * never clipped by #conv-list's scroll container, flipped upward
       * near the viewport bottom (jsrt has no layout — the guard keeps
       * the default CSS anchoring there) */
      if (menuBtn.getBoundingClientRect && window.innerHeight) {
        const r = menuBtn.getBoundingClientRect();
        pop.style.position = "fixed";
        pop.style.right = "auto";
        pop.style.left = Math.max(8, r.right - 130) + "px";
        if (r.bottom + 96 > window.innerHeight) {
          pop.style.top = "auto";
          pop.style.bottom = (window.innerHeight - r.top + 4) + "px";
        } else {
          pop.style.bottom = "auto";
          pop.style.top = (r.bottom + 4) + "px";
        }
      }
      pop.classList.add("visible");
    };
    li.append(title, menuBtn, pop);
    ul.appendChild(li);
  });
}

/* close every floating popover (conv menus, account menu, params
 * sheet) — ONE manager, called by the global outside-click/Escape
 * handlers and before opening any popover, so two can never stack */
function closePopovers() {
  document.querySelectorAll(".conv-menu-pop.visible")
    .forEach((el) => el.classList.remove("visible"));
  document.querySelectorAll(".menu.visible")
    .forEach((el) => el.classList.remove("visible"));
  const pop = document.querySelector("#params-pop");
  if (pop && pop.classList.contains("open")) {
    pop.classList.remove("open");
    document.body.classList.remove("sheet-open");
  }
}

async function selectConversation(id, { push = true } = {}) {
  state.current = id;
  /* pushState so browser back/forward walks the conversation history
   * (reference main.js:175 popstate handling) */
  if (push && window.location.pathname !== `/chat/${id}`) {
    history.pushState({ conv: id }, "", `/chat/${id}`);
  }
  const conv = state.conversations.find((c) => c.id === id);
  $("#conv-title").textContent = conv ? conv.title : "";
  await loadMessages();
  loadConversations();
}

async function loadMessages() {
  if (!state.current) { showGreeting(); return; }
  const resp = await api(`/conversations/${state.current}/messages`);
  const data = await resp.json();
  const box = $("#messages");
  box.innerHTML = "";
  if (!data.messages.length) { showGreeting(); return; }
  data.messages.forEach((m) =>
    appendMessage(m.role, m.content, m.id,
                  { model: m.model, created_at: m.created_at })
  );
  box.scrollTop = box.scrollHeight;
}

/* empty-state greeting with suggestion chips (reference app.js:389-407) */
function showGreeting() {
  const box = $("#messages");
  box.innerHTML = "";
  const div = document.createElement("div");
  div.className = "greeting";
  const name = (state.me?.name || "").trim();
  const title = document.createElement("div");
  title.className = "greet-title";
  title.textContent = name ? `Hello, ${name}!` : "Hello!";
  const sub = document.createElement("div");
  sub.className = "greet-sub";
  sub.textContent = "Ask anything about the wiki, or start from an example";
  const chips = document.createElement("div");
  chips.className = "greet-suggestions";
  [
    "Summarize the getting-started guide",
    "What changed in the latest release notes?",
    "Explain how authentication works",
  ].forEach((text) => {
    const chip = document.createElement("button");
    chip.className = "chip";
    chip.textContent = text;
    chip.onclick = () => {
      const input = $("#input");
      input.value = text;
      input.focus();
      sendQuestion();
    };
    chips.appendChild(chip);
  });
  div.append(title, sub, chips);
  box.appendChild(div);
}

/* copy-to-clipboard on any message (reference app.js:482,601); copies
 * the raw text with the hidden [SourcesMap]/thinking markers stripped */
function copyableText(content) {
  return (content || "")
    .replace(/\n<!--thinking-->\n[\s\S]*?\n<!--\/thinking-->\n/g, "")
    .split("\n")
    .filter((l) => !l.startsWith("[SourcesMap]:"))
    .join("\n")
    .trim();
}

function attachCopy(div, content) {
  const btn = document.createElement("button");
  btn.className = "copy";
  btn.title = "Copy";
  btn.textContent = "⧉";
  btn.onclick = async () => {
    try {
      await navigator.clipboard.writeText(copyableText(content));
      toast("Copied", "success", 1500);
    } catch (e) {
      toast("Copy failed", "error");
    }
  };
  div.appendChild(btn);
}

function appendMessage(role, content, id, meta) {
  const div = document.createElement("div");
  div.className = "msg " + role;
  if (id) div.dataset.id = id;
  if (role === "assistant") {
    /* avatar + bubble (reference renders a model avatar beside each
     * assistant message); streaming appends into the bubble */
    const avatar = document.createElement("span");
    avatar.className = "avatar";
    avatar.innerHTML = meta && meta.model ? modelIcon(meta.model) : APP_ICON;
    const bubble = document.createElement("div");
    bubble.className = "bubble";
    bubble.innerHTML = renderAssistant(content || "");
    const col = document.createElement("div");
    col.className = "bubble-col";
    col.appendChild(bubble);
    /* meta line under the bubble: which model answered and when
     * (reference app.js msg-meta: model · params · timestamp) */
    if (meta && (meta.model || meta.created_at)) {
      const m = document.createElement("div");
      m.className = "msg-meta";
      const name = meta.model
        ? (state.models?.find((x) => x.id === meta.model)?.label || meta.model)
        : "";
      const when = meta.created_at ? fmtTime(meta.created_at) : "";
      m.textContent = [name, when].filter(Boolean).join(" · ");
      col.appendChild(m);
    }
    div.append(avatar, col);
    if (content) attachCopy(bubble, content);
  } else {
    div.innerHTML = renderMarkdownLite(content || "");
    const edit = document.createElement("button");
    edit.className = "edit";
    edit.textContent = "✎";
    edit.onclick = () => startEdit(id, content);
    div.appendChild(edit);
  }
  $("#messages").appendChild(div);
  return div;
}

/* timestamps come back as sqlite UTC "YYYY-MM-DD HH:MM:SS" or ISO */
function fmtTime(ts) {
  const d = new Date(String(ts).includes("T") ? ts : ts + "Z");
  if (isNaN(d.getTime())) return "";
  return d.toLocaleString([], {
    month: "short", day: "numeric", hour: "2-digit", minute: "2-digit",
  });
}

/* edit-resubmit: visible editing state on the composer with an
 * explicit escape hatch (reference chat.css is-editing ring +
 * cancel-edit-btn) */
function startEdit(id, content) {
  const input = $("#input");
  input.value = content;
  if (id) {
    /* only persisted messages can edit-resubmit; a live-appended
     * (id-less) message just prefills the composer */
    input.dataset.editId = id;
    $("#composer").classList.add("editing");
    $("#cancel-edit").hidden = false;
  }
  input.focus();
}

function cancelEdit() {
  const composer = $("#composer");
  if (!composer.classList.contains("editing")) return;
  const input = $("#input");
  delete input.dataset.editId;
  input.value = "";
  composer.classList.remove("editing");
  $("#cancel-edit").hidden = true;
}

/* Follow the stream only while the reader is pinned to the bottom:
 * scrolling up to re-read must not be yanked back down by every SSE
 * frame (reference behavior; 48px of slack keeps the pin sticky
 * through sub-line growth). A DOM without layout (the CI stub) has no
 * clientHeight — treat it as pinned. */
function autoscroll(box) {
  const ch = box.clientHeight;
  if (ch !== undefined &&
      box.scrollHeight - box.scrollTop - ch >= 48) {
    return;
  }
  box.scrollTop = box.scrollHeight;
}

// ---------- ask / SSE ----------

async function sendQuestion() {
  const input = $("#input");
  const question = input.value.trim();
  if (!question || state.streaming) return;
  /* claim the flag BEFORE any await: a key-repeat double Enter would
   * otherwise pass the guard while the first call is suspended creating
   * the conversation, duplicating it and interleaving two streams */
  state.streaming = true;
  try {
    if (!state.current) {
      const resp = await api("/conversations", {
        method: "POST",
        body: JSON.stringify({ title: question.slice(0, 48) }),
      });
      const conv = await resp.json();
      state.current = conv.id;
      await loadConversations();
    }
  } catch (e) {
    state.streaming = false;
    throw e;
  }
  const editId = input.dataset.editId || null;
  input.value = "";
  delete input.dataset.editId;
  $("#composer").classList.remove("editing");
  $("#cancel-edit").hidden = true;
  if (editId) {
    try {
      await loadMessages();
    } catch (e) {
      /* release the claim: a failed repaint here would otherwise leave
       * streaming=true forever and permanently disable the composer */
      state.streaming = false;
      throw e;
    }
  }
  const greet = document.querySelector("#messages .greeting");
  if (greet) greet.remove();
  appendMessage("user", question);

  const assistantDiv = appendMessage("assistant", "");
  const bubble = assistantDiv.querySelector(".bubble") || assistantDiv;
  assistantDiv.classList.add("streaming");
  $("#send").hidden = true;
  $("#stop").hidden = false;
  state.abort = new AbortController();

  /* Incremental rendering (reference app.js:547-875 re-renders at \n\n
   * boundaries): completed paragraphs are rendered ONCE and appended to
   * a stable container; only the trailing partial paragraph re-renders
   * per SSE frame — O(answer) total instead of O(answer^2). A boundary
   * only advances when the prefix has balanced ``` fences AND balanced
   * $$ math fences, so a code block or display-math block containing
   * blank lines is never split mid-fence. */
  let thinkEl = null, thinkBody = null;
  const stableEl = document.createElement("div");
  const tailEl = document.createElement("div");
  bubble.append(stableEl, tailEl);
  let stableCut = 0;
  const fencesBalanced = (s) => {
    const parts = s.split("```");
    if ((parts.length - 1) % 2 !== 0) return false;
    // count $$ only OUTSIDE code fences: a lone $$ inside a shell or
    // Makefile snippet must not freeze the stable cut forever
    let dollars = 0;
    for (let i = 0; i < parts.length; i += 2) dollars += parts[i].split("$$").length - 1;
    return dollars % 2 === 0;
  };
  const renderTick = (content) => {
    let cut = content.lastIndexOf("\n\n");
    while (cut > stableCut && !fencesBalanced(content.slice(0, cut))) {
      cut = content.lastIndexOf("\n\n", cut - 1);
    }
    if (cut > stableCut && fencesBalanced(content.slice(0, cut))) {
      stableEl.insertAdjacentHTML(
        "beforeend", renderMarkdownLite(content.slice(stableCut, cut))
      );
      stableCut = cut;
    }
    tailEl.innerHTML = renderMarkdownLite(content.slice(stableCut));
  };

  let content = "", thinking = "", failed = false;
  try {
    const resp = await fetch(API + "/ask", {
      method: "POST",
      headers: { "content-type": "application/json" },
      credentials: "same-origin",
      signal: state.abort.signal,
      body: JSON.stringify({
        question,
        conversation_id: state.current,
        model: $("#model-picker").value,
        temperature: state.params.temperature ?? undefined,
        top_p: state.params.top_p ?? undefined,
        edit_message_id: editId ? parseInt(editId, 10) : undefined,
      }),
    });
    if (resp.status === 401) {
      /* auth redirect, not a network failure: mark failed so the catch
       * doesn't paint "connection lost" while navigating to login */
      failed = true;
      window.location.href = "/chat/login";
      throw new Error("unauthorized");
    }
    if (!resp.ok) {
      failed = true;
      bubble.insertAdjacentHTML(
        "beforeend",
        `<p class='error'>request failed (${resp.status})</p>`
      );
      throw new Error("ask failed " + resp.status);
    }
    const reader = resp.body.getReader();
    const decoder = new TextDecoder();
    let buf = "";
    for (;;) {
      const { done, value } = await reader.read();
      if (done) break;
      buf += decoder.decode(value, { stream: true });
      const frames = buf.split("\n\n");
      buf = frames.pop();
      for (const frame of frames) {
        const line = frame.split("\n").find((l) => l.startsWith("data:"));
        if (!line) continue;
        const payload = line.slice(5).trim();
        if (payload === "[DONE]") continue;
        let obj;
        try { obj = JSON.parse(payload); } catch (e) { continue; }
        const delta = obj.choices?.[0]?.delta || {};
        if (obj.model) {
          /* model badge on the avatar: which model is answering
           * (reference shows the model's brand icon per message) */
          const av = assistantDiv.querySelector(".avatar");
          if (av && av.dataset.model !== obj.model) {
            av.dataset.model = obj.model;
            av.innerHTML = modelIcon(obj.model);
            av.title = obj.model;
          }
        }
        if (delta.thinking) {
          thinking += delta.thinking;
          if (!thinkEl) {
            thinkEl = document.createElement("details");
            thinkEl.className = "thinking";
            thinkEl.open = true;
            thinkEl.innerHTML = "<summary>thinking</summary>";
            thinkBody = document.createElement("div");
            thinkEl.appendChild(thinkBody);
            bubble.insertBefore(thinkEl, stableEl);
          }
          /* append only the delta as a fading span (reference
           * appendFadeInChunk): O(total) work and the streaming
           * fade-in effect, instead of re-setting the whole text */
          const chunk = document.createElement("span");
          chunk.className = "fade-chunk";
          chunk.textContent = delta.thinking;
          thinkBody.appendChild(chunk);
        }
        if (delta.content) {
          content += delta.content;
          if (thinkEl) thinkEl.open = false; // answer started: fold it
          renderTick(content);
        }
        autoscroll($("#messages"));
      }
    }
  } catch (e) {
    if (e.name !== "AbortError" && !failed) {
      failed = true;
      bubble.insertAdjacentHTML("beforeend", "<p class='error'>connection lost</p>");
    }
  } finally {
    assistantDiv.classList.remove("streaming");
    state.streaming = false;
    state.abort = null;
    $("#send").hidden = false;
    $("#stop").hidden = true;
    /* on failure, keep the partial answer + error indicator on screen —
     * an immediate repaint from persistence would wipe them (and the
     * fetch would likely fail on a dead connection anyway) */
    if (!failed) loadMessages(); // pick up persisted ids + sources map
  }
}

// ---------- refresh status polling ----------

let refreshTimer = null;

async function triggerRefresh() {
  const resp = await api("/../update/all", { method: "POST" });
  if (resp.status === 429) {
    $("#refresh-status").textContent = "refresh already running";
  }
  pollRefresh();
}

async function pollRefresh() {
  if (refreshTimer) clearInterval(refreshTimer);
  refreshTimer = setInterval(async () => {
    let st;
    const el = $("#refresh-status");
    try {
      const resp = await api("/refresh/status");
      st = await resp.json();
    } catch (e) {
      // session expired / server restarting: stop polling instead of an
      // every-3s unhandled-rejection (and, on 401, redirect) storm
      el.textContent = "status unavailable";
      clearInterval(refreshTimer);
      return;
    }
    if (st.state === "running") {
      const pct = Math.round((st.progress || 0) * 100);
      el.textContent = `refreshing… ${pct}% (${st.success || 0} ok, ${st.skipped || 0} skipped)`;
    } else if (st.state === "done") {
      el.textContent = `done: ${st.success} indexed, ${st.skipped} skipped`;
      clearInterval(refreshTimer);
    } else if (st.state === "failed") {
      el.textContent = "refresh failed";
      clearInterval(refreshTimer);
    } else {
      el.textContent = "";
      clearInterval(refreshTimer);
    }
  }, 3000);
}

// ---------- theme / composer helpers (reference: main.js) ----------

/* Three-way theme: light / dark / system (reference main.js:5-64).
 * "system" follows prefers-color-scheme live; the resolved value lands
 * on <html data-theme>, the user's *choice* in localStorage. */
const _sysDark = window.matchMedia
  ? window.matchMedia("(prefers-color-scheme: dark)") : null;

function applyTheme(choice) {
  const resolved = choice === "system"
    ? (_sysDark && _sysDark.matches ? "dark" : "light") : choice;
  document.documentElement.dataset.theme = resolved;
  try { localStorage.setItem("theme", choice); } catch (e) {}
  const btn = $("#theme-toggle");
  if (btn) {
    btn.textContent = choice === "system" ? "◑" : resolved === "light" ? "🌙" : "☀";
    btn.title = `Theme: ${choice} (click to cycle)`;
  }
}

if (_sysDark && _sysDark.addEventListener) {
  _sysDark.addEventListener("change", () => {
    let choice = "dark";
    try { choice = localStorage.getItem("theme") || "dark"; } catch (e) {}
    if (choice === "system") applyTheme("system");
  });
}

function autoresize(el) {
  el.style.height = "auto";
  el.style.height = Math.min(el.scrollHeight, 200) + "px";
}

async function uploadFile(file) {
  const form = new FormData();
  form.append("file", file);
  const resp = await fetch(API + "/upload", {
    method: "POST",
    credentials: "same-origin",
    body: form,
  });
  if (resp.ok) {
    toast(`Uploaded ${file.name}`, "success");
  } else {
    let msg = "upload failed";
    try { msg = (await resp.json()).error || msg; } catch (e) {}
    toast(msg, "error");
  }
}

// ---------- boot ----------

window.addEventListener("DOMContentLoaded", async () => {
  let theme = "dark";
  try { theme = localStorage.getItem("theme") || "dark"; } catch (e) {}
  applyTheme(theme);
  await loadMe();
  await loadConversations();
  const m = window.location.pathname.match(/\/chat\/([0-9a-f-]{36})$/);
  if (m) await selectConversation(m[1], { push: false });
  else showGreeting();
  window.addEventListener("popstate", () => {
    const pm = window.location.pathname.match(/\/chat\/([0-9a-f-]{36})$/);
    if (pm) selectConversation(pm[1], { push: false });
    else {
      state.current = null;
      $("#conv-title").textContent = "New conversation";
      showGreeting();
      loadConversations();
    }
  });
  $("#send").onclick = sendQuestion;
  $("#stop").onclick = () => state.abort && state.abort.abort();
  const input = $("#input");
  input.addEventListener("keydown", (e) => {
    if (e.key === "Enter" && !e.shiftKey) {
      e.preventDefault();
      sendQuestion();
    } else if (e.key === "Escape") {
      cancelEdit();
    }
  });
  $("#cancel-edit").onclick = cancelEdit;
  input.addEventListener("input", () => autoresize(input));
  $("#new-conv").onclick = async () => {
    state.current = null;
    $("#conv-title").textContent = "New conversation";
    history.pushState({ conv: null }, "", "/chat/");
    showGreeting();
    loadConversations();
  };
  $("#refresh-kb").onclick = triggerRefresh;
  $("#model-picker").onchange = syncModelIcon;
  /* mobile sidebar: a veil behind the open drawer closes it on tap
   * (reference sidebar.css .sidebar-veil) */
  const sideToggle = (open) => {
    $("#sidebar").classList.toggle("open", open);
    document.body.classList.toggle("side-open", open);
  };
  $("#menu-toggle").onclick = () =>
    sideToggle(!$("#sidebar").classList.contains("open"));
  $("#side-veil").onclick = () => sideToggle(false);
  $("#theme-toggle").onclick = () => {
    let choice = "dark";
    try { choice = localStorage.getItem("theme") || "dark"; } catch (e) {}
    const order = ["dark", "light", "system"];
    applyTheme(order[(order.indexOf(choice) + 1) % order.length]);
    syncThemeRadios();
  };
  document.addEventListener("click", () => closePopovers());
  document.addEventListener("keydown", (e) => {
    if (e.key === "Escape") closePopovers();
  });

  // sampling-params popover; becomes a bottom sheet on mobile
  // (reference: model/temp/top-p popovers + mobile sheet, main.js:204-473)
  // — opened through the one popover manager so it can never stack with
  // the account menu or a conversation menu
  const pop = $("#params-pop");
  pop.onclick = (e) => e.stopPropagation();
  $("#params-toggle").onclick = (e) => {
    e.stopPropagation();
    const open = pop.classList.contains("open");
    closePopovers();
    if (!open) {
      pop.classList.add("open");
      document.body.classList.add("sheet-open");
    }
  };
  const tempSlider = $("#temp-slider"), topPSlider = $("#top-p-slider");
  const sync = () => {
    state.params.temperature = tempSlider.value === "" ? null : parseFloat(tempSlider.value);
    state.params.top_p = topPSlider.value === "" ? null : parseFloat(topPSlider.value);
    $("#temp-val").textContent = tempSlider.value;
    $("#top-p-val").textContent = topPSlider.value;
  };
  tempSlider.oninput = sync;
  topPSlider.oninput = sync;
  $("#params-reset").onclick = () => {
    tempSlider.value = "0.7";
    topPSlider.value = "0.9";
    sync();
    state.params = { temperature: null, top_p: null };
    $("#temp-val").textContent = "default";
    $("#top-p-val").textContent = "default";
  };

  // attachment upload (reference: upload button -> /api/upload)
  const fileInput = $("#file-input");
  $("#upload-btn").onclick = () => fileInput.click();
  fileInput.onchange = () => {
    if (fileInput.files.length) uploadFile(fileInput.files[0]);
    fileInput.value = "";
  };
});
