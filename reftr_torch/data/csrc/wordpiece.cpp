// WordPiece tokenizer with character-offset tracking.
//
// Native replacement for the HuggingFace fast (Rust) tokenizers the
// reference RefTR uses (resc_refer_dataset.py:43-48, refer_dataset.py:
// 43-48), including the char_to_token offset mapping needed for
// multi-phrase span extraction (refer_dataset.py:160-171).
//
// Implements the BERT pipeline: text cleanup -> basic tokenization
// (lowercase, accent stripping for Latin-1/combining marks, punctuation
// splitting, CJK isolation) -> greedy longest-match WordPiece with "##"
// continuations. Offsets are in Unicode code points of the original string,
// matching the HF convention consumed by the reference.
//
// C ABI for ctypes; no external dependencies.

#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  bool lower = true;
  int32_t unk_id = -1, cls_id = -1, sep_id = -1, pad_id = -1;
  int max_chars_per_word = 100;
};

// ---------- UTF-8 <-> code points ----------

// Decode UTF-8; invalid bytes become U+FFFD.
static std::vector<uint32_t> decode_utf8(const char* s) {
  std::vector<uint32_t> cps;
  const auto* p = reinterpret_cast<const unsigned char*>(s);
  while (*p) {
    uint32_t cp = 0xFFFD;
    int len = 1;
    if (*p < 0x80) {
      cp = *p;
    } else if ((*p >> 5) == 0x6 && (p[1] & 0xC0) == 0x80) {
      cp = ((*p & 0x1F) << 6) | (p[1] & 0x3F);
      len = 2;
    } else if ((*p >> 4) == 0xE && (p[1] & 0xC0) == 0x80 &&
               (p[2] & 0xC0) == 0x80) {
      cp = ((*p & 0x0F) << 12) | ((p[1] & 0x3F) << 6) | (p[2] & 0x3F);
      len = 3;
    } else if ((*p >> 3) == 0x1E && (p[1] & 0xC0) == 0x80 &&
               (p[2] & 0xC0) == 0x80 && (p[3] & 0xC0) == 0x80) {
      cp = ((*p & 0x07) << 18) | ((p[1] & 0x3F) << 12) | ((p[2] & 0x3F) << 6) |
           (p[3] & 0x3F);
      len = 4;
    }
    cps.push_back(cp);
    p += len;
  }
  return cps;
}

static void append_utf8(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out.push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// ---------- character classes (BERT basic tokenizer rules) ----------

static bool is_whitespace(uint32_t c) {
  if (c == ' ' || c == '\t' || c == '\n' || c == '\r') return true;
  // Zs category common members
  return c == 0x00A0 || (c >= 0x2000 && c <= 0x200A) || c == 0x202F ||
         c == 0x205F || c == 0x3000;
}

static bool is_control(uint32_t c) {
  if (c == '\t' || c == '\n' || c == '\r') return false;  // treated as ws
  return c < 0x20 || c == 0x7F || (c >= 0x80 && c <= 0x9F) || c == 0x200B ||
         c == 0x200C || c == 0x200D || c == 0xFEFF;
}

static bool is_punctuation(uint32_t c) {
  // ASCII punctuation blocks (BERT treats all non-alnum ASCII as punct)
  if ((c >= 33 && c <= 47) || (c >= 58 && c <= 64) || (c >= 91 && c <= 96) ||
      (c >= 123 && c <= 126))
    return true;
  // General punctuation / common unicode punctuation ranges
  return (c >= 0x2010 && c <= 0x2027) || (c >= 0x2030 && c <= 0x205E) ||
         c == 0x00A1 || c == 0x00BF || c == 0x00AB || c == 0x00BB ||
         c == 0x2E2E || (c >= 0x3001 && c <= 0x3003) || c == 0x30FB;
}

static bool is_cjk(uint32_t c) {
  return (c >= 0x4E00 && c <= 0x9FFF) || (c >= 0x3400 && c <= 0x4DBF) ||
         (c >= 0x20000 && c <= 0x2A6DF) || (c >= 0x2A700 && c <= 0x2B73F) ||
         (c >= 0x2B740 && c <= 0x2B81F) || (c >= 0x2B820 && c <= 0x2CEAF) ||
         (c >= 0xF900 && c <= 0xFAFF) || (c >= 0x2F800 && c <= 0x2FA1F);
}

static bool is_combining_mark(uint32_t c) {
  // Mn blocks that matter for Latin accent stripping (NFD combining marks)
  return (c >= 0x0300 && c <= 0x036F) || (c >= 0x1AB0 && c <= 0x1AFF) ||
         (c >= 0x1DC0 && c <= 0x1DFF) || (c >= 0x20D0 && c <= 0x20FF);
}

// Lowercase + NFD-decompose common Latin letters. Returns 0 if the char
// should be dropped (combining mark after stripping).
static uint32_t lower_strip(uint32_t c, bool lower) {
  if (lower) {
    if (c >= 'A' && c <= 'Z') return c + 32;
    if (c >= 0xC0 && c <= 0xDE && c != 0xD7) c += 0x20;  // Latin-1 capitals
  }
  // NFD for Latin-1: a-with-accent -> base letter (accent stripped)
  static const struct {
    uint32_t from, to;
    char base;
  } kLatin1[] = {
      {0xE0, 0xE5, 'a'}, {0xE8, 0xEB, 'e'}, {0xEC, 0xEF, 'i'},
      {0xF2, 0xF6, 'o'}, {0xF9, 0xFC, 'u'}, {0xFD, 0xFD, 'y'},
      {0xFF, 0xFF, 'y'}, {0xE7, 0xE7, 'c'}, {0xF1, 0xF1, 'n'},
  };
  for (const auto& r : kLatin1)
    if (c >= r.from && c <= r.to) return static_cast<uint32_t>(r.base);
  if (is_combining_mark(c)) return 0;
  return c;
}

struct Word {
  std::string text;                  // normalized utf-8
  std::vector<int32_t> char_index;   // original codepoint index per norm char
};

// basic tokenization: returns words with per-character original offsets
static std::vector<Word> basic_tokenize(const std::vector<uint32_t>& cps,
                                        bool lower) {
  std::vector<Word> words;
  Word cur;
  auto flush = [&]() {
    if (!cur.text.empty()) {
      words.push_back(cur);
      cur = Word{};
    }
  };
  for (size_t i = 0; i < cps.size(); ++i) {
    uint32_t c = cps[i];
    if (c == 0 || c == 0xFFFD || is_control(c)) continue;
    if (is_whitespace(c)) {
      flush();
      continue;
    }
    uint32_t n = lower_strip(c, lower);
    if (n == 0) continue;  // stripped accent
    if (is_punctuation(n) || is_cjk(n)) {
      flush();
      Word w;
      size_t before = w.text.size();
      append_utf8(w.text, n);
      for (size_t k = before; k < w.text.size(); ++k)
        w.char_index.push_back(static_cast<int32_t>(i));
      words.push_back(w);
      continue;
    }
    size_t before = cur.text.size();
    append_utf8(cur.text, n);
    for (size_t k = before; k < cur.text.size(); ++k)
      cur.char_index.push_back(static_cast<int32_t>(i));
  }
  flush();
  return words;
}

struct Piece {
  int32_t id;
  int32_t start, end;  // original codepoint span [start, end)
};

static void wordpiece(const Tokenizer& t, const Word& w,
                      std::vector<Piece>& out) {
  const std::string& s = w.text;
  // spans in normalized bytes -> original codepoints via char_index
  auto orig_start = [&](size_t b) { return w.char_index[b]; };
  auto orig_end = [&](size_t b) { return w.char_index[b - 1] + 1; };

  // count codepoints cheaply: bytes with (b & 0xC0) != 0x80
  int n_chars = 0;
  for (unsigned char b : s)
    if ((b & 0xC0) != 0x80) ++n_chars;
  if (n_chars > t.max_chars_per_word) {
    out.push_back({t.unk_id, orig_start(0), orig_end(s.size())});
    return;
  }

  std::vector<Piece> pieces;
  size_t start = 0;
  while (start < s.size()) {
    size_t end = s.size();
    int32_t cur_id = -1;
    size_t cur_end = 0;
    while (start < end) {
      std::string sub = s.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = t.vocab.find(sub);
      if (it != t.vocab.end()) {
        cur_id = it->second;
        cur_end = end;
        break;
      }
      // shrink by one codepoint (skip continuation bytes)
      do {
        --end;
      } while (end > start && (static_cast<unsigned char>(s[end]) & 0xC0) == 0x80);
    }
    if (cur_id < 0) {  // no piece found -> whole word is UNK
      out.push_back({t.unk_id, orig_start(0), orig_end(s.size())});
      return;
    }
    pieces.push_back({cur_id, orig_start(start), orig_end(cur_end)});
    start = cur_end;
  }
  for (const auto& p : pieces) out.push_back(p);
}

}  // namespace

extern "C" {

void* rtok_create(const char* vocab_path, int do_lower) {
  auto* t = new Tokenizer();
  t->lower = do_lower != 0;
  std::ifstream f(vocab_path);
  if (!f.good()) {
    delete t;
    return nullptr;
  }
  std::string line;
  int32_t idx = 0;
  while (std::getline(f, line)) {
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    t->vocab.emplace(line, idx++);
  }
  auto get = [&](const char* tok) {
    auto it = t->vocab.find(tok);
    return it == t->vocab.end() ? -1 : it->second;
  };
  t->unk_id = get("[UNK]");
  t->cls_id = get("[CLS]");
  t->sep_id = get("[SEP]");
  t->pad_id = get("[PAD]");
  return t;
}

void rtok_free(void* tp) { delete static_cast<Tokenizer*>(tp); }

int rtok_vocab_size(void* tp) {
  return static_cast<int>(static_cast<Tokenizer*>(tp)->vocab.size());
}

int rtok_token_id(void* tp, const char* token) {
  auto* t = static_cast<Tokenizer*>(tp);
  auto it = t->vocab.find(token);
  return it == t->vocab.end() ? -1 : it->second;
}

// Encode text. Writes up to max_len entries into out_ids / out_start /
// out_end (offsets (0,0) for special tokens, HF convention). Returns the
// number of tokens written. add_special: wrap with [CLS]/[SEP] and truncate
// the inner sequence to max_len-2 (HF truncation strategy 'longest_first'
// for a single sequence).
int rtok_encode(void* tp, const char* text, int add_special, int max_len,
                int32_t* out_ids, int32_t* out_start, int32_t* out_end) {
  auto* t = static_cast<Tokenizer*>(tp);
  std::vector<uint32_t> cps = decode_utf8(text);
  std::vector<Piece> pieces;
  for (const auto& w : basic_tokenize(cps, t->lower)) wordpiece(*t, w, pieces);

  int budget = add_special ? max_len - 2 : max_len;
  if (budget < 0) budget = 0;
  if (static_cast<int>(pieces.size()) > budget) pieces.resize(budget);

  int n = 0;
  if (add_special) {
    out_ids[n] = t->cls_id;
    out_start[n] = 0;
    out_end[n] = 0;
    ++n;
  }
  for (const auto& p : pieces) {
    out_ids[n] = p.id;
    out_start[n] = p.start;
    out_end[n] = p.end;
    ++n;
  }
  if (add_special) {
    out_ids[n] = t->sep_id;
    out_start[n] = 0;
    out_end[n] = 0;
    ++n;
  }
  return n;
}

}  // extern "C"
