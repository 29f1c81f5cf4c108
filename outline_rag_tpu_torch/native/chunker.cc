// Native recursive character chunker.
//
// Hot loop of the ingestion path (SURVEY.md section 3.3: "split 1024/100 +
// title injection — hot loop per chunk", reference app/rag.py:195-209).
// Semantics mirror outline_rag_tpu_torch/utils/chunking.py::split_text exactly:
// recursive splitting over the separator ladder {"\n\n", "\n", " ", ""}
// with greedy merge to chunk_size and trailing-overlap carry. Operates on
// UTF-32 code points (the Python wrapper passes UTF-32LE) so sizes match
// Python's str semantics. Returns chunk spans (offset, length) into the
// input; chunks are always contiguous substrings, so no copies are made.
//
// C ABI for ctypes; no dependencies beyond the C++ standard library.

#include <cstdint>
#include <vector>

namespace {

struct Span {
  int off;
  int len;
};

constexpr int kLevels = 4;  // "\n\n", "\n", " ", "" (char level)

inline bool is_space(uint32_t c) {
  // full Unicode whitespace, matching Python str.strip()/str.isspace():
  // ASCII-only stripping diverges from the Python reference on CJK
  // (U+3000), NBSP and typographic spaces — different chunk texts mean
  // different stable_chunk_ids per build environment
  switch (c) {
    case ' ': case '\t': case '\n': case '\r': case '\f': case '\v':
    case 0x1c: case 0x1d: case 0x1e: case 0x1f: case 0x85: case 0xa0:
    case 0x1680: case 0x2028: case 0x2029: case 0x202f: case 0x205f:
    case 0x3000:
      return true;
    default:
      return c >= 0x2000 && c <= 0x200a;
  }
}

// Does separator `level` occur in [lo, hi)?
bool sep_present(const uint32_t* t, int lo, int hi, int level) {
  if (level == 0) {
    for (int i = lo; i + 1 < hi; ++i)
      if (t[i] == '\n' && t[i + 1] == '\n') return true;
    return false;
  }
  if (level == 1) {
    for (int i = lo; i < hi; ++i)
      if (t[i] == '\n') return true;
    return false;
  }
  if (level == 2) {
    for (int i = lo; i < hi; ++i)
      if (t[i] == ' ') return true;
    return false;
  }
  return true;  // char level always "splits"
}

// Split [lo, hi) by the first present separator from `level` downward,
// separator attached to the end of each piece (empty tokens dropped).
// Mirrors _split_on.
void split_on(const uint32_t* t, int lo, int hi, int level,
              std::vector<Span>* out) {
  if (level >= kLevels) {
    if (hi > lo) out->push_back({lo, hi - lo});
    return;
  }
  if (level == kLevels - 1) {  // "" -> single code points
    for (int i = lo; i < hi; ++i) out->push_back({i, 1});
    return;
  }
  if (!sep_present(t, lo, hi, level)) {
    split_on(t, lo, hi, level + 1, out);
    return;
  }
  int sep_len = (level == 0) ? 2 : 1;
  int start = lo;
  int i = lo;
  while (i < hi) {
    bool hit = false;
    if (level == 0) {
      hit = (i + 1 < hi && t[i] == '\n' && t[i + 1] == '\n');
    } else if (level == 1) {
      hit = (t[i] == '\n');
    } else {
      hit = (t[i] == ' ');
    }
    if (hit) {
      int end = i + sep_len;  // separator attached
      if (end > start) out->push_back({start, end - start});
      start = end;
      i = end;
    } else {
      ++i;
    }
  }
  if (hi > start) out->push_back({start, hi - start});
}

// Mirrors _recursive_pieces: pieces that fit (or bottom level) are kept,
// oversize pieces recurse with the next separator.
void recursive_pieces(const uint32_t* t, int lo, int hi, int chunk_size,
                      int level, std::vector<Span>* out) {
  std::vector<Span> parts;
  split_on(t, lo, hi, level, &parts);
  for (const Span& p : parts) {
    if (p.len <= chunk_size || level >= kLevels - 1) {
      if (p.len > 0) out->push_back(p);
    } else {
      recursive_pieces(t, p.off, p.off + p.len, chunk_size, level + 1, out);
    }
  }
}

Span strip_span(const uint32_t* t, int off, int len) {
  int s = off, e = off + len;
  while (s < e && is_space(t[s])) ++s;
  while (e > s && is_space(t[e - 1])) --e;
  return {s, e - s};
}

}  // namespace

extern "C" {

// Returns the number of chunks written (<= max_chunks), or -1 on error.
// out_off/out_len receive spans into the input codepoint array.
int ort_chunk_text(const uint32_t* text, int n, int chunk_size,
                   int chunk_overlap, int* out_off, int* out_len,
                   int max_chunks) {
  if (chunk_overlap >= chunk_size || chunk_size <= 0) return -1;
  Span whole = strip_span(text, 0, n);
  if (whole.len == 0) return 0;
  int count = 0;
  if (whole.len <= chunk_size) {
    if (max_chunks < 1) return -1;
    out_off[0] = whole.off;
    out_len[0] = whole.len;
    return 1;
  }
  std::vector<Span> pieces;
  recursive_pieces(text, whole.off, whole.off + whole.len, chunk_size, 0,
                   &pieces);
  std::vector<Span> cur;  // contiguous run of pieces
  int cur_len = 0;
  auto emit = [&](void) -> bool {
    if (cur.empty()) return true;
    int off = cur.front().off;
    int len = cur.back().off + cur.back().len - off;
    Span s = strip_span(text, off, len);
    if (s.len > 0) {
      if (count >= max_chunks) return false;
      out_off[count] = s.off;
      out_len[count] = s.len;
      ++count;
    }
    return true;
  };
  for (const Span& p : pieces) {
    if (!cur.empty() && cur_len + p.len > chunk_size) {
      if (!emit()) return -1;
      // carry trailing pieces totalling <= chunk_overlap
      std::vector<Span> keep;
      int keep_len = 0;
      for (auto it = cur.rbegin(); it != cur.rend(); ++it) {
        if (keep_len + it->len > chunk_overlap) break;
        keep.push_back(*it);
        keep_len += it->len;
      }
      cur.assign(keep.rbegin(), keep.rend());
      cur_len = keep_len;
      // overlap + incoming piece must respect chunk_size (mirror of the
      // Python merge: pop leading carried pieces until it fits)
      while (!cur.empty() && cur_len + p.len > chunk_size) {
        cur_len -= cur.front().len;
        cur.erase(cur.begin());
      }
    }
    cur.push_back(p);
    cur_len += p.len;
  }
  if (!emit()) return -1;
  return count;
}

}  // extern "C"
