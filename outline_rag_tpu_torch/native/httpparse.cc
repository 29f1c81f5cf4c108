// HTTP/1.1 request-head parser — the native transport piece of the
// first-party server (serve/http.py), standing in for the reference's
// uvloop/httptools C extensions (SURVEY.md section 2b).
//
// Parses one request head from a byte buffer in a single pass: request
// line (method, target) plus header name/value spans, with header names
// lower-cased into a caller-provided scratch buffer so Python builds its
// dict from ready-made slices instead of running per-header str ops.
//
// Returns:
//   >0  bytes consumed (the head length including the blank line)
//    0  incomplete (no terminating CRLFCRLF in the buffer)
//   -1  malformed request line
//   -2  too many headers for the caller's span capacity
extern "C" {

struct ort_span {
  int off;
  int len;
};

int ort_parse_request_head(const unsigned char* buf, int len,
                           ort_span* method, ort_span* target,
                           ort_span* version,
                           // per header: name(off,len into lowered), value(off,len into buf)
                           ort_span* names, ort_span* values, int max_headers,
                           int* n_headers,
                           unsigned char* lowered /* len-sized scratch */) {
  // find end of head
  int end = -1;
  for (int i = 0; i + 3 < len; i++) {
    if (buf[i] == '\r' && buf[i + 1] == '\n' && buf[i + 2] == '\r' &&
        buf[i + 3] == '\n') {
      end = i + 4;
      break;
    }
  }
  if (end < 0) return 0;

  // request line: METHOD SP TARGET SP VERSION CRLF
  int i = 0;
  int sp1 = -1, sp2 = -1, eol = -1;
  for (; i < end; i++) {
    if (buf[i] == ' ') {
      if (sp1 < 0) sp1 = i;
      else if (sp2 < 0) sp2 = i;
    } else if (buf[i] == '\r') {
      eol = i;
      break;
    }
  }
  if (sp1 <= 0 || sp2 <= sp1 + 0 || eol <= sp2) return -1;
  method->off = 0;
  method->len = sp1;
  target->off = sp1 + 1;
  target->len = sp2 - sp1 - 1;
  version->off = sp2 + 1;
  version->len = eol - sp2 - 1;
  if (target->len <= 0) return -1;

  // headers
  int count = 0;
  i = eol + 2;
  while (i < end - 2) {  // stop before the final CRLF
    int line_start = i;
    int colon = -1, line_end = -1;
    for (int j = i; j + 1 < end; j++) {
      if (buf[j] == ':' && colon < 0) colon = j;
      if (buf[j] == '\r' && buf[j + 1] == '\n') {
        line_end = j;
        break;
      }
    }
    if (line_end < 0) break;
    if (line_end == line_start) break;  // blank line
    if (colon > line_start && colon < line_end) {
      if (count >= max_headers) return -2;
      // lower-case + trim the name into the scratch buffer
      int ns = line_start, ne = colon;
      while (ns < ne && (buf[ns] == ' ' || buf[ns] == '\t')) ns++;
      while (ne > ns && (buf[ne - 1] == ' ' || buf[ne - 1] == '\t')) ne--;
      for (int j = ns; j < ne; j++) {
        unsigned char c = buf[j];
        lowered[j] = (c >= 'A' && c <= 'Z') ? (unsigned char)(c + 32) : c;
      }
      names[count].off = ns;
      names[count].len = ne - ns;
      // trim the value
      int vs = colon + 1, ve = line_end;
      while (vs < ve && (buf[vs] == ' ' || buf[vs] == '\t')) vs++;
      while (ve > vs && (buf[ve - 1] == ' ' || buf[ve - 1] == '\t')) ve--;
      values[count].off = vs;
      values[count].len = ve - vs;
      count++;
    }
    i = line_end + 2;
  }
  *n_headers = count;
  return end;
}

}  // extern "C"
