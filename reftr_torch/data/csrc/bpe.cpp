// Byte-level BPE tokenizer (GPT-2/RoBERTa style) with char offsets.
//
// Native replacement for HF's Rust RobertaTokenizerFast, used when the
// reference is configured with --bert_model roberta-* (reftr_transformer.py:
// 315-316, configs/flickr30k/RefTR_flickr_roberta.sh). Loads the standard
// vocab.json + merges.txt pair, applies the GPT-2 pre-tokenization pattern
// and byte->unicode mapping, greedy lowest-rank pair merging, and tracks
// original-string character offsets per token (trim_offsets=True semantics:
// the leading space is excluded from a token's span).
//
// C ABI for ctypes; no external deps (a tiny purpose-built JSON scanner
// reads vocab.json's flat {token: id} object).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------- GPT-2 byte <-> unicode symbol table ----------

static void build_byte_table(std::string table[256]) {
  // printable bytes map to themselves; the rest get 256+n codepoints
  std::vector<int> bs;
  for (int b = 33; b <= 126; ++b) bs.push_back(b);
  for (int b = 161; b <= 172; ++b) bs.push_back(b);
  for (int b = 174; b <= 255; ++b) bs.push_back(b);
  std::vector<int> cs(bs.begin(), bs.end());
  int n = 0;
  for (int b = 0; b < 256; ++b) {
    if (std::find(bs.begin(), bs.end(), b) == bs.end()) {
      bs.push_back(b);
      cs.push_back(256 + n);
      ++n;
    }
  }
  auto append_cp = [](std::string& out, int cp) {
    if (cp < 0x80) {
      out.push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
      out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
      out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
      out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
      out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
  };
  for (size_t i = 0; i < bs.size(); ++i) {
    std::string s;
    append_cp(s, cs[i]);
    table[bs[i]] = s;
  }
}

struct BPE {
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_map<std::string, int32_t> rank;  // "left right" -> rank
  std::string byte_sym[256];
  int32_t bos = 0, eos = 2, pad = 1, unk = 3;
};

// minimal JSON reader for a flat {"token": id, ...} object
static bool load_vocab_json(const std::string& path,
                            std::unordered_map<std::string, int32_t>& out) {
  std::ifstream f(path, std::ios::binary);
  if (!f.good()) return false;
  std::stringstream ss;
  ss << f.rdbuf();
  const std::string s = ss.str();
  size_t i = 0;
  auto skip_ws = [&]() {
    while (i < s.size() && (s[i] == ' ' || s[i] == '\n' || s[i] == '\t' ||
                            s[i] == '\r' || s[i] == ','))
      ++i;
  };
  skip_ws();
  if (i >= s.size() || s[i] != '{') return false;
  ++i;
  while (true) {
    skip_ws();
    if (i >= s.size() || s[i] == '}') break;
    if (s[i] != '"') return false;
    ++i;
    std::string key;
    while (i < s.size() && s[i] != '"') {
      if (s[i] == '\\' && i + 1 < s.size()) {
        ++i;
        char c = s[i];
        if (c == 'n') key.push_back('\n');
        else if (c == 't') key.push_back('\t');
        else if (c == 'r') key.push_back('\r');
        else if (c == 'u' && i + 4 < s.size()) {
          int cp = std::stoi(s.substr(i + 1, 4), nullptr, 16);
          i += 4;
          if (cp < 0x80) key.push_back(static_cast<char>(cp));
          else if (cp < 0x800) {
            key.push_back(static_cast<char>(0xC0 | (cp >> 6)));
            key.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
          } else {
            key.push_back(static_cast<char>(0xE0 | (cp >> 12)));
            key.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
            key.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
          }
        } else key.push_back(c);
      } else {
        key.push_back(s[i]);
      }
      ++i;
    }
    ++i;  // closing quote
    skip_ws();
    if (i >= s.size() || s[i] != ':') return false;
    ++i;
    skip_ws();
    size_t j = i;
    while (j < s.size() && (isdigit(s[j]) || s[j] == '-')) ++j;
    out[key] = std::stoi(s.substr(i, j - i));
    i = j;
  }
  return true;
}

// ---------- pre-tokenization (GPT-2 pattern, ASCII approximation) ----------

struct Chunk {
  size_t byte_start, byte_end;  // [start, end) in the input utf-8
};

static bool is_space_b(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}
static bool is_letter_b(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || c >= 0x80;
}
static bool is_digit_b(unsigned char c) { return c >= '0' && c <= '9'; }

// GPT-2: 's|'t|'re|'ve|'m|'ll|'d| ?\pL+| ?\pN+| ?[^\s\pL\pN]+|\s+(?!\S)|\s+
// Hand-rolled scanner honoring the alternation order exactly (with the
// standard ASCII approximation of \pL/\pN; non-ASCII bytes count as
// letters).
static std::vector<Chunk> pretokenize(const std::string& s) {
  std::vector<Chunk> chunks;
  const size_t n = s.size();
  auto is_punct = [&](unsigned char c) {
    return !is_space_b(c) && !is_letter_b(c) && !is_digit_b(c);
  };
  auto contraction_len = [&](size_t p) -> size_t {
    if (p >= n || s[p] != '\'') return 0;
    static const char* suf[] = {"re", "ve", "ll", "s", "t", "m", "d"};
    for (const char* x : suf) {
      size_t len = std::strlen(x);
      if (p + 1 + len <= n && s.compare(p + 1, len, x) == 0) return 1 + len;
    }
    return 0;
  };
  size_t i = 0;
  while (i < n) {
    // 1. contraction
    if (size_t len = contraction_len(i)) {
      chunks.push_back({i, i + len});
      i += len;
      continue;
    }
    // 2-4. optional single leading space + run of letters/digits/punct
    size_t p = i + (s[i] == ' ' && i + 1 < n ? 1 : 0);
    if (p < n) {
      unsigned char c = s[p];
      if (is_letter_b(c)) {
        while (p < n && is_letter_b(static_cast<unsigned char>(s[p]))) ++p;
        chunks.push_back({i, p});
        i = p;
        continue;
      }
      if (is_digit_b(c)) {
        while (p < n && is_digit_b(static_cast<unsigned char>(s[p]))) ++p;
        chunks.push_back({i, p});
        i = p;
        continue;
      }
      if (is_punct(c)) {
        while (p < n && is_punct(static_cast<unsigned char>(s[p]))) ++p;
        chunks.push_back({i, p});
        i = p;
        continue;
      }
    }
    // 5-6. whitespace run: keep the last space for the next token unless
    // the run reaches end-of-string
    size_t j = i;
    while (j < n && is_space_b(static_cast<unsigned char>(s[j]))) ++j;
    if (j >= n) {
      chunks.push_back({i, j});
      i = j;
    } else if (j - i > 1) {
      chunks.push_back({i, j - 1});
      i = j - 1;
    } else {
      // single space followed by a space-starting alternative that failed:
      // emit it alone (defensive; shouldn't occur)
      chunks.push_back({i, j});
      i = j;
    }
  }
  return chunks;
}

struct PieceOut {
  int32_t id;
  int32_t char_start, char_end;  // untrimmed char span
  int32_t lead, trail;           // leading/trailing space chars in the token
};

static void bpe_chunk(const BPE& t, const std::string& text,
                      const Chunk& ch, const std::vector<int32_t>& char_of_byte,
                      std::vector<PieceOut>& out) {
  // symbols: byte-level unicode strings, one per input byte initially
  std::vector<std::string> syms;
  std::vector<int32_t> first_byte, last_byte;  // original byte spans
  for (size_t b = ch.byte_start; b < ch.byte_end; ++b) {
    syms.push_back(t.byte_sym[static_cast<unsigned char>(text[b])]);
    first_byte.push_back(static_cast<int32_t>(b));
    last_byte.push_back(static_cast<int32_t>(b));
  }
  // greedy lowest-rank merges
  while (syms.size() > 1) {
    int best_rank = std::numeric_limits<int>::max();
    int best_i = -1;
    for (size_t i2 = 0; i2 + 1 < syms.size(); ++i2) {
      auto it = t.rank.find(syms[i2] + " " + syms[i2 + 1]);
      if (it != t.rank.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = static_cast<int>(i2);
      }
    }
    if (best_i < 0) break;
    syms[best_i] += syms[best_i + 1];
    last_byte[best_i] = last_byte[best_i + 1];
    syms.erase(syms.begin() + best_i + 1);
    first_byte.erase(first_byte.begin() + best_i + 1);
    last_byte.erase(last_byte.begin() + best_i + 1);
  }
  for (size_t i2 = 0; i2 < syms.size(); ++i2) {
    auto it = t.vocab.find(syms[i2]);
    int32_t id = it == t.vocab.end() ? t.unk : it->second;
    int32_t b0 = first_byte[i2], b1 = last_byte[i2];
    int32_t lead = 0, trail = 0;
    for (int32_t b = b0; b <= b1 && is_space_b(text[b]); ++b) ++lead;
    for (int32_t b = b1; b >= b0 && is_space_b(text[b]); --b) ++trail;
    out.push_back({id, char_of_byte[b0], char_of_byte[b1] + 1, lead, trail});
  }
}

}  // namespace

extern "C" {

void* rbpe_create(const char* vocab_json, const char* merges_txt) {
  auto* t = new BPE();
  build_byte_table(t->byte_sym);
  if (!load_vocab_json(vocab_json, t->vocab)) {
    delete t;
    return nullptr;
  }
  std::ifstream mf(merges_txt);
  if (!mf.good()) {
    delete t;
    return nullptr;
  }
  std::string line;
  int32_t r = 0;
  bool first = true;
  while (std::getline(mf, line)) {
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    if (first && line.rfind("#version", 0) == 0) {
      first = false;
      continue;
    }
    first = false;
    if (line.empty()) continue;
    t->rank[line] = r++;
  }
  auto get = [&](const char* tok, int32_t dflt) {
    auto it = t->vocab.find(tok);
    return it == t->vocab.end() ? dflt : it->second;
  };
  t->bos = get("<s>", 0);
  t->eos = get("</s>", 2);
  t->pad = get("<pad>", 1);
  t->unk = get("<unk>", 3);
  return t;
}

void rbpe_free(void* tp) { delete static_cast<BPE*>(tp); }

int rbpe_vocab_size(void* tp) {
  return static_cast<int>(static_cast<BPE*>(tp)->vocab.size());
}

int rbpe_pad_id(void* tp) { return static_cast<BPE*>(tp)->pad; }
int rbpe_bos_id(void* tp) { return static_cast<BPE*>(tp)->bos; }
int rbpe_eos_id(void* tp) { return static_cast<BPE*>(tp)->eos; }

// Encode with <s>/</s> wrapping when add_special; offsets (0,0) for special
// tokens. Returns token count written (<= max_len).
int rbpe_encode(void* tp, const char* text, int add_special, int max_len,
                int32_t* out_ids, int32_t* out_start, int32_t* out_end) {
  auto* t = static_cast<BPE*>(tp);
  const std::string s(text);
  // byte index -> char (codepoint) index
  std::vector<int32_t> char_of_byte(s.size() + 1, 0);
  int32_t cp = 0;
  for (size_t b = 0; b < s.size(); ++b) {
    char_of_byte[b] = cp;
    if ((static_cast<unsigned char>(s[b]) & 0xC0) != 0x80) {
      // count this byte as the start of a codepoint
    }
    if (b + 1 == s.size() ||
        (static_cast<unsigned char>(s[b + 1]) & 0xC0) != 0x80)
      ++cp;
  }
  char_of_byte[s.size()] = cp;

  std::vector<PieceOut> pieces;
  for (const auto& ch : pretokenize(s))
    bpe_chunk(*t, s, ch, char_of_byte, pieces);
  // HF ByteLevel trim_offsets: shift start past leading spaces (except for
  // the very first token anchored at 0), then pull end back over trailing
  // spaces; clamp so start <= end.
  for (size_t i = 0; i < pieces.size(); ++i) {
    auto& p = pieces[i];
    if (p.lead > 0 && !(i == 0 && p.char_start == 0))
      p.char_start = std::min(p.char_start + p.lead, p.char_end);
    if (p.trail > 0)
      p.char_end = std::max(p.char_end - p.trail, p.char_start);
  }

  int budget = add_special ? max_len - 2 : max_len;
  if (budget < 0) budget = 0;
  if (static_cast<int>(pieces.size()) > budget) pieces.resize(budget);
  int n = 0;
  if (add_special) {
    out_ids[n] = t->bos;
    out_start[n] = 0;
    out_end[n] = 0;
    ++n;
  }
  for (const auto& p : pieces) {
    out_ids[n] = p.id;
    out_start[n] = p.char_start;
    out_end[n] = p.char_end;
    ++n;
  }
  if (add_special) {
    out_ids[n] = t->eos;
    out_start[n] = 0;
    out_end[n] = 0;
    ++n;
  }
  return n;
}

}  // extern "C"
