// Native byte-level BPE encoder for the CLIP tokenizer hot loop.
//
// The framework's runtime-native component layer (see native/__init__.py):
// the reference stack leans on transformers' Rust tokenizers for this
// (reference encode/clip.py:57-63 via CLIPTokenizer); here the merge loop —
// the only super-linear part of prompt encoding — is C++ behind a ctypes
// boundary, with unicode pre-tokenization kept in Python where the regex
// semantics already match HF exactly (text/tokenizer.py).
//
// Contract with text/tokenizer.py:
//   * create() receives the vocab as "id\ttoken" lines and the merges as
//     "first second" lines (rank = line order) — both already in the
//     byte-encoded space of vocab.json/merges.txt.
//   * encode_words() receives '\n'-separated *raw* pre-tokens (output of
//     the CLIP pre-tokenization regex; never contains whitespace), applies
//     the GPT-2 byte→unicode mapping, runs the BPE merge loop per word
//     (with a per-handle word cache), and emits vocab ids.
//   * Any token that resolves to a symbol missing from the vocab yields
//     CLIP_BPE_UNKNOWN; the Python caller falls back to its own
//     implementation for that text (parity over availability).
//
// Thread-safety: encode is guarded by a mutex (the word cache is shared);
// ctypes releases the GIL around calls, so tokenization overlaps device
// work in the serving path.

#include <algorithm>
#include <array>
#include <climits>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr long kUnknown = -1;
constexpr long kOverflow = -2;

std::string cp_utf8(int cp) {
  std::string s;
  if (cp < 0x80) {
    s.push_back(static_cast<char>(cp));
  } else {  // byte-encoder codepoints max out at 256+67 < 0x800
    s.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    s.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
  return s;
}

// GPT-2 bytes_to_unicode(): printable bytes map to themselves, the rest to
// 256+n in ascending byte order (text/tokenizer.py:bytes_to_unicode).
std::array<std::string, 256> make_byte_encoder() {
  std::array<bool, 256> printable{};
  for (int b = '!'; b <= '~'; ++b) printable[b] = true;
  for (int b = 0xA1; b <= 0xAC; ++b) printable[b] = true;
  for (int b = 0xAE; b <= 0xFF; ++b) printable[b] = true;
  std::array<std::string, 256> enc;
  int n = 0;
  for (int b = 0; b < 256; ++b)
    enc[b] = cp_utf8(printable[b] ? b : 256 + n++);
  return enc;
}

std::string pair_key(const std::string& a, const std::string& b) {
  std::string k;
  k.reserve(a.size() + b.size() + 1);
  k += a;
  k += '\x01';  // never occurs: byte-encoded symbols are printable UTF-8
  k += b;
  return k;
}

struct Handle {
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_map<std::string, int> ranks;
  std::array<std::string, 256> byte_enc = make_byte_encoder();
  std::unordered_map<std::string, std::vector<int32_t>> cache;
  std::mutex mu;

  // The merge loop, matching text/tokenizer.py:CLIPTokenizer._bpe exactly:
  // repeatedly merge the lowest-ranked adjacent pair, scanning occurrences
  // left to right.
  bool bpe(const std::string& word, std::vector<int32_t>* out) {
    std::vector<std::string> sym;
    sym.reserve(word.size() + 1);
    for (unsigned char c : word) sym.push_back(byte_enc[c]);
    sym.back() += "</w>";

    while (sym.size() > 1) {
      int best = INT_MAX;
      size_t bi = 0;
      for (size_t i = 0; i + 1 < sym.size(); ++i) {
        auto it = ranks.find(pair_key(sym[i], sym[i + 1]));
        if (it != ranks.end() && it->second < best) {
          best = it->second;
          bi = i;
        }
      }
      if (best == INT_MAX) break;
      const std::string first = sym[bi], second = sym[bi + 1];
      std::vector<std::string> merged;
      merged.reserve(sym.size());
      size_t i = 0;
      while (i < sym.size()) {
        size_t j = i;
        while (j < sym.size() && sym[j] != first) ++j;
        merged.insert(merged.end(), sym.begin() + i, sym.begin() + j);
        if (j == sym.size()) break;
        i = j;
        if (i + 1 < sym.size() && sym[i + 1] == second) {
          merged.push_back(first + second);
          i += 2;
        } else {
          merged.push_back(sym[i]);
          i += 1;
        }
      }
      sym.swap(merged);
    }

    out->reserve(out->size() + sym.size());
    for (const auto& s : sym) {
      auto it = vocab.find(s);
      if (it == vocab.end()) return false;
      out->push_back(it->second);
    }
    return true;
  }
};

}  // namespace

extern "C" {

void* clip_bpe_create(const char* vocab_tsv, const char* merges_lines) {
  auto* h = new Handle();
  const char* p = vocab_tsv;
  while (*p) {
    const char* tab = std::strchr(p, '\t');
    const char* nl = std::strchr(p, '\n');
    if (!nl) nl = p + std::strlen(p);
    if (tab && tab < nl) {
      int32_t id = static_cast<int32_t>(std::strtol(p, nullptr, 10));
      h->vocab.emplace(std::string(tab + 1, nl - tab - 1), id);
    }
    p = *nl ? nl + 1 : nl;
  }
  int rank = 0;
  p = merges_lines;
  while (*p) {
    const char* sp = std::strchr(p, ' ');
    const char* nl = std::strchr(p, '\n');
    if (!nl) nl = p + std::strlen(p);
    if (sp && sp < nl)
      h->ranks.emplace(
          pair_key(std::string(p, sp - p), std::string(sp + 1, nl - sp - 1)),
          rank++);
    p = *nl ? nl + 1 : nl;
  }
  return h;
}

void clip_bpe_destroy(void* handle) { delete static_cast<Handle*>(handle); }

// words: '\n'-separated raw pre-tokens. Returns the number of ids written,
// kUnknown on an out-of-vocab symbol, kOverflow if cap is too small.
long clip_bpe_encode_words(void* handle, const char* words, int32_t* out,
                           long cap) {
  auto* h = static_cast<Handle*>(handle);
  std::lock_guard<std::mutex> lock(h->mu);
  long n = 0;
  const char* p = words;
  while (*p) {
    const char* nl = std::strchr(p, '\n');
    if (!nl) nl = p + std::strlen(p);
    if (nl > p) {
      std::string word(p, nl - p);
      auto it = h->cache.find(word);
      if (it == h->cache.end()) {
        std::vector<int32_t> ids;
        if (!h->bpe(word, &ids)) return kUnknown;
        it = h->cache.emplace(std::move(word), std::move(ids)).first;
      }
      const auto& ids = it->second;
      if (n + static_cast<long>(ids.size()) > cap) return kOverflow;
      std::copy(ids.begin(), ids.end(), out + n);
      n += static_cast<long>(ids.size());
    }
    p = *nl ? nl + 1 : nl;
  }
  return n;
}

}  // extern "C"
