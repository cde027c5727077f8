// A zstd decoder (RFC 8878) for the host, with a plain C interface for
// ctypes: the C++ twin of train/zstd.py, which is its reference.  It reads
// the frames zstd writes without a dictionary: raw, RLE and compressed
// blocks; raw, RLE, Huffman and treeless literals in 1 or 4 streams, Huffman
// weights direct or FSE-compressed; sequences with predefined, RLE,
// described and repeated FSE tables, carried across the blocks of a frame;
// the repeat offsets; skippable frames; the XXH64 content checksum.
//
// Built at first use with the host compiler by ops/_build.py and loaded by
// train/zstd_native.py.

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct TooSmall {};

[[noreturn]] void fail(const char* what) { throw Error(what); }

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr int64_t kBlockMax = 1 << 17;

inline uint64_t mask(int n) { return n >= 64 ? ~0ull : ((1ull << n) - 1); }

inline uint64_t load_le(const uint8_t* p, int64_t n) {
  uint64_t v = 0;
  std::memcpy(&v, p, static_cast<size_t>(n));
  return v;
}

// the 8 bytes at p, or the avail < 8 there are, zero-extended
inline uint64_t load_upto8(const uint8_t* p, int64_t avail) {
  if (avail >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
  }
  return load_le(p, avail);
}

// --- XXH64 -----------------------------------------------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}

uint64_t xxh64(const uint8_t* p, int64_t n) {
  int64_t i = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
    for (; i + 32 <= n; i += 32)
      for (int k = 0; k < 4; ++k)
        v[k] = xround(v[k], load_le(p + i + 8 * k, 8));
    h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
    for (int k = 0; k < 4; ++k) h = (h ^ xround(0, v[k])) * P1 + P4;
  } else {
    h = P5;
  }
  h += static_cast<uint64_t>(n);
  for (; i + 8 <= n; i += 8) {
    h ^= xround(0, load_le(p + i, 8));
    h = rotl(h, 27) * P1 + P4;
  }
  if (i + 4 <= n) {
    h ^= load_le(p + i, 4) * P1;
    h = rotl(h, 23) * P2 + P3;
    i += 4;
  }
  for (; i < n; ++i) {
    h ^= p[i] * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// --- bit readers -----------------------------------------------------------

// Little-endian bits from the front; bits past the end read as zeros (the
// caller checks bytes_used).
struct Forward {
  const uint8_t* s;
  int64_t len, bit = 0;
  uint64_t peek(int n) const {
    int64_t lo = bit, b = lo >> 3;
    if (b >= len) return 0;
    int64_t avail = len - b;
    return (load_upto8(s + b, avail) >> (lo & 7)) & mask(n);
  }
  uint64_t read(int n) {
    uint64_t v = peek(n);
    bit += n;
    return v;
  }
  int64_t bytes_used() const {
    int64_t used = (bit + 7) >> 3;
    if (used > len) fail("FSE table description past its section");
    return used;
  }
};

// Bits from the end towards the start, after the padding marker (the
// highest set bit of the last byte).  Reading past the start gives zeros
// and leaves pos negative: the callers check.
struct Backward {
  const uint8_t* s;
  int64_t len, pos;
  Backward(const uint8_t* s_, int64_t len_) : s(s_), len(len_) {
    if (len <= 0 || s[len - 1] == 0) fail("bitstream without its end marker");
    pos = (len - 1) * 8 + (31 - __builtin_clz(s[len - 1]));
  }
  uint64_t peek(int n) const {
    if (n == 0) return 0;
    int64_t lo = pos - n;
    if (lo >= 0) {
      int64_t b = lo >> 3, avail = len - b;
      return (load_upto8(s + b, avail) >> (lo & 7)) & mask(n);
    }
    if (pos <= 0) return 0;
    return (load_le(s, (pos + 7) >> 3) & mask(static_cast<int>(pos))) << (-lo);
  }
  uint64_t read(int n) {
    uint64_t v = peek(n);
    pos -= n;
    return v;
  }
};

// --- FSE -------------------------------------------------------------------

struct Fse {
  std::vector<uint8_t> sym, nb;
  std::vector<uint32_t> base;
  int log = 0;
  bool set = false;
};

int64_t read_fse_counts(const uint8_t* s, int64_t len, int max_symbol,
                        int max_log, std::vector<int>& counts, int& log) {
  Forward bits{s, len};
  log = static_cast<int>(bits.read(4)) + 5;
  if (log > max_log) fail("FSE accuracy log over its maximum");
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  counts.clear();
  while (remaining > 1) {
    if (static_cast<int>(counts.size()) > max_symbol)
      fail("FSE table description has too many symbols");
    int mx = (2 * threshold - 1) - remaining;
    int low = static_cast<int>(bits.peek(nbits - 1)) & (threshold - 1);
    int val;
    if (low < mx) {
      val = low;
      bits.read(nbits - 1);
    } else {
      val = static_cast<int>(bits.read(nbits)) & (2 * threshold - 1);
      if (val >= threshold) val -= mx;
    }
    int count = val - 1;
    remaining -= count < 0 ? -count : count;
    counts.push_back(count);
    if (count == 0) {
      for (;;) {
        int rep = static_cast<int>(bits.read(2));
        counts.insert(counts.end(), rep, 0);
        if (rep != 3) break;
        if (static_cast<int>(counts.size()) > max_symbol + 1) break;
      }
      if (static_cast<int>(counts.size()) > max_symbol + 1)
        fail("FSE zero run past the last symbol");
    }
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("FSE counts do not sum to the table size");
  return bits.bytes_used();
}

void build_fse(const std::vector<int>& counts, int log, Fse& t) {
  const int size = 1 << log;
  t.sym.assign(size, 0);
  t.nb.assign(size, 0);
  t.base.assign(size, 0);
  t.log = log;
  t.set = true;
  int high = size - 1;
  std::vector<uint32_t> next(counts.size());
  for (size_t s = 0; s < counts.size(); ++s) {
    if (counts[s] == -1) {
      if (high < 0) fail("FSE table overfull");
      t.sym[high--] = static_cast<uint8_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint32_t>(counts[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  int pos = 0;
  for (size_t s = 0; s < counts.size(); ++s)
    for (int i = 0; i < counts[s]; ++i) {
      t.sym[pos] = static_cast<uint8_t>(s);
      pos = (pos + step) & (size - 1);
      while (pos > high) pos = (pos + step) & (size - 1);
    }
  if (pos != 0) fail("FSE table spread did not come back to 0");
  for (int u = 0; u < size; ++u) {
    uint32_t x = next[t.sym[u]]++;
    if (x == 0) fail("FSE state of a symbol with no count");
    int nb = log - (31 - __builtin_clz(x));
    t.nb[u] = static_cast<uint8_t>(nb);
    t.base[u] = (x << nb) - static_cast<uint32_t>(size);
  }
}

void rle_fse(uint8_t sym, Fse& t) {
  t.sym.assign(1, sym);
  t.nb.assign(1, 0);
  t.base.assign(1, 0);
  t.log = 0;
  t.set = true;
}

const int kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                            2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                            2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,    1,    2,     3,     4,     5,    6,
                              7,    8,    9,     10,    11,    12,   13,
                              14,   15,   16,    18,    20,    22,   24,
                              28,   32,   40,    48,    64,    128,  256,
                              512,  1024, 2048,  4096,  8192,  16384,
                              32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26,  27,  28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43, 47,  51,  59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,  4,  4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// --- Huffman ---------------------------------------------------------------

struct Huffman {
  std::vector<uint8_t> sym, len;
  int max_bits = 0;
  bool set = false;
};

int64_t huffman_weights(const uint8_t* s, int64_t avail,
                        std::vector<int>& w) {
  if (avail < 1) fail("Huffman tree description missing");
  const int head = s[0];
  w.clear();
  if (head >= 128) {
    const int n = head - 127;
    const int64_t used = 1 + (n + 1) / 2;
    if (used > avail) fail("Huffman weights past the literals section");
    for (int i = 0; i < n; ++i) {
      uint8_t b = s[1 + i / 2];
      w.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
    return used;
  }
  if (1 + head > avail) fail("Huffman weights past the literals section");
  std::vector<int> counts;
  int log;
  int64_t used = read_fse_counts(s + 1, head, 255, 6, counts, log);
  Fse t;
  build_fse(counts, log, t);
  Backward bits(s + 1 + used, head - used);
  uint32_t s1 = static_cast<uint32_t>(bits.read(log));
  uint32_t s2 = static_cast<uint32_t>(bits.read(log));
  for (;;) {
    if (w.size() > 254) fail("too many Huffman weights");
    w.push_back(t.sym[s1]);
    s1 = t.base[s1] + static_cast<uint32_t>(bits.read(t.nb[s1]));
    if (bits.pos < 0) {
      w.push_back(t.sym[s2]);
      break;
    }
    w.push_back(t.sym[s2]);
    s2 = t.base[s2] + static_cast<uint32_t>(bits.read(t.nb[s2]));
    if (bits.pos < 0) {
      w.push_back(t.sym[s1]);
      break;
    }
  }
  return 1 + head;
}

void build_huffman(std::vector<int> w, Huffman& h) {
  if (w.empty()) fail("bad Huffman weights");
  uint64_t total = 0;
  for (int x : w) {
    if (x > 11) fail("bad Huffman weights");
    if (x) total += 1ull << (x - 1);
  }
  if (total == 0) fail("Huffman weights all zero");
  int max_bits = 64 - __builtin_clzll(total);
  uint64_t rest = (1ull << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not complete a power of 2");
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  w.push_back(64 - __builtin_clzll(rest));
  const int size = 1 << max_bits;
  h.sym.assign(size, 0);
  h.len.assign(size, 0);
  h.max_bits = max_bits;
  h.set = true;
  int pos = 0;
  for (int wt = 1; wt <= max_bits; ++wt)
    for (size_t s = 0; s < w.size(); ++s)
      if (w[s] == wt) {
        int n = 1 << (wt - 1);
        for (int k = 0; k < n; ++k) {
          h.sym[pos + k] = static_cast<uint8_t>(s);
          h.len[pos + k] = static_cast<uint8_t>(max_bits + 1 - wt);
        }
        pos += n;
      }
}

void huffman_stream(const uint8_t* s, int64_t len, const Huffman& h,
                    int64_t n, uint8_t* out) {
  Backward bits(s, len);
  const int mb = h.max_bits;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t k = bits.peek(mb);
    out[i] = h.sym[k];
    bits.pos -= h.len[k];
  }
  if (bits.pos != 0) fail("Huffman stream not consumed exactly");
}

// --- frames ----------------------------------------------------------------

struct Frame {
  Huffman huf;
  Fse ll, of, ml;
  uint64_t reps[3] = {1, 4, 8};
  std::vector<uint8_t> lits;
};

struct Out {
  uint8_t* p;
  int64_t cap, n = 0;
  void need(int64_t k) const {
    if (n + k > cap) throw TooSmall();
  }
};

// the literals section at s[0:len]; returns its size
int64_t literals(const uint8_t* s, int64_t len, Frame& fr) {
  const int b0 = s[0], kind = b0 & 3, fmt = (b0 >> 2) & 3;
  if (kind == 0 || kind == 1) {
    static const int hs[4] = {1, 2, 1, 3};
    const int hsize = hs[fmt];
    if (hsize > len) fail("literals header past the block");
    uint64_t h = load_le(s, hsize);
    int64_t size = static_cast<int64_t>(hsize == 1 ? h >> 3 : h >> 4);
    if (kind == 0) {
      if (hsize + size > len) fail("raw literals past the block");
      fr.lits.assign(s + hsize, s + hsize + size);
      return hsize + size;
    }
    if (hsize + 1 > len) fail("RLE literals past the block");
    fr.lits.assign(static_cast<size_t>(size), s[hsize]);
    return hsize + 1;
  }
  static const int hs[4] = {3, 3, 4, 5}, nbs[4] = {10, 10, 14, 18};
  const int hsize = hs[fmt], nb = nbs[fmt], streams = fmt == 0 ? 1 : 4;
  if (hsize > len) fail("literals header past the block");
  uint64_t h = load_le(s, hsize);
  const int64_t regen = static_cast<int64_t>((h >> 4) & mask(nb));
  const int64_t csize = static_cast<int64_t>((h >> (4 + nb)) & mask(nb));
  if (hsize + csize > len) fail("compressed literals past the block");
  const uint8_t* p = s + hsize;
  const uint8_t* stop = p + csize;
  if (kind == 2) {
    std::vector<int> w;
    p += huffman_weights(p, csize, w);
    build_huffman(w, fr.huf);
  } else if (!fr.huf.set) {
    fail("treeless literals without an earlier table");
  }
  fr.lits.resize(static_cast<size_t>(regen));
  if (streams == 1) {
    huffman_stream(p, stop - p, fr.huf, regen, fr.lits.data());
  } else {
    if (p + 6 > stop) fail("literals jump table past the section");
    int64_t sz[4] = {static_cast<int64_t>(load_le(p, 2)),
                     static_cast<int64_t>(load_le(p + 2, 2)),
                     static_cast<int64_t>(load_le(p + 4, 2)), 0};
    const int64_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("4 literal streams for under 4 bytes a stream");
    p += 6;
    if (p + sz[0] + sz[1] + sz[2] > stop)
      fail("literals jump table past the section");
    sz[3] = stop - p - sz[0] - sz[1] - sz[2];
    for (int i = 0; i < 4; ++i) {
      huffman_stream(p, sz[i], fr.huf, i < 3 ? seg : regen - 3 * seg,
                     fr.lits.data() + i * seg);
      p += sz[i];
    }
  }
  return hsize + csize;
}

int64_t sequence_table(const uint8_t* s, int64_t len, int mode, Fse& t,
                       const int* def, int ndef, int def_log, int max_symbol,
                       int max_log) {
  if (mode == 0) {
    build_fse(std::vector<int>(def, def + ndef), def_log, t);
    return 0;
  }
  if (mode == 1) {
    if (len < 1) fail("RLE symbol past the block");
    if (s[0] > max_symbol) fail("RLE symbol out of range");
    rle_fse(s[0], t);
    return 1;
  }
  if (mode == 2) {
    std::vector<int> counts;
    int log;
    int64_t used = read_fse_counts(s, len, max_symbol, max_log, counts, log);
    build_fse(counts, log, t);
    return used;
  }
  if (!t.set) fail("repeat table without an earlier one");
  return 0;
}

void block(const uint8_t* s, int64_t len, Frame& fr, Out& out,
           int64_t frame_start) {
  int64_t pos = literals(s, len, fr);
  if (pos >= len) fail("sequences section missing");
  const int b0 = s[pos];
  int64_t nseq;
  if (b0 < 128) {
    nseq = b0;
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > len) fail("sequence count past the block");
    nseq = ((b0 - 128) << 8) + s[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > len) fail("sequence count past the block");
    nseq = s[pos + 1] + (s[pos + 2] << 8) + 0x7F00;
    pos += 3;
  }
  const std::vector<uint8_t>& lits = fr.lits;
  const int64_t nlits = static_cast<int64_t>(lits.size());
  if (nseq == 0) {
    if (pos != len) fail("bytes after an empty sequences section");
    out.need(nlits);
    std::memcpy(out.p + out.n, lits.data(), static_cast<size_t>(nlits));
    out.n += nlits;
    return;
  }
  if (pos >= len) fail("sequence modes past the block");
  const int modes = s[pos++];
  if (modes & 3) fail("reserved bits set in the sequence modes");
  pos += sequence_table(s + pos, len - pos, modes >> 6, fr.ll, kLLDefault, 36,
                        6, 35, 9);
  pos += sequence_table(s + pos, len - pos, (modes >> 4) & 3, fr.of,
                        kOFDefault, 29, 5, 31, 8);
  pos += sequence_table(s + pos, len - pos, (modes >> 2) & 3, fr.ml,
                        kMLDefault, 53, 6, 52, 9);
  if (pos > len) fail("sequence tables past the block");
  Backward bits(s + pos, len - pos);
  uint32_t ls = static_cast<uint32_t>(bits.read(fr.ll.log));
  uint32_t os = static_cast<uint32_t>(bits.read(fr.of.log));
  uint32_t ms = static_cast<uint32_t>(bits.read(fr.ml.log));
  uint64_t* reps = fr.reps;
  int64_t lit = 0;
  for (int64_t i = 0; i < nseq; ++i) {
    const int ocode = fr.of.sym[os], mcode = fr.ml.sym[ms],
              lcode = fr.ll.sym[ls];
    if (ocode > 31) fail("offset code over 31");
    const uint64_t oval = (1ull << ocode) + bits.read(ocode);
    const int64_t mlen = kMLBase[mcode] + bits.read(kMLBits[mcode]);
    const int64_t llen = kLLBase[lcode] + bits.read(kLLBits[lcode]);
    uint64_t off;
    if (oval > 3) {
      off = oval - 3;
      reps[2] = reps[1];
      reps[1] = reps[0];
      reps[0] = off;
    } else {
      const uint64_t idx = oval + (llen == 0 ? 1 : 0);
      if (idx == 1) {
        off = reps[0];
      } else if (idx == 2) {
        off = reps[1];
        reps[1] = reps[0];
        reps[0] = off;
      } else {
        off = idx == 3 ? reps[2] : reps[0] - 1;
        reps[2] = reps[1];
        reps[1] = reps[0];
        reps[0] = off;
      }
    }
    if (i + 1 < nseq) {
      ls = fr.ll.base[ls] + static_cast<uint32_t>(bits.read(fr.ll.nb[ls]));
      ms = fr.ml.base[ms] + static_cast<uint32_t>(bits.read(fr.ml.nb[ms]));
      os = fr.of.base[os] + static_cast<uint32_t>(bits.read(fr.of.nb[os]));
    }
    if (bits.pos < 0) fail("sequences bitstream overrun");
    if (lit + llen > nlits)
      fail("sequence takes more literals than there are");
    out.need(llen + mlen);
    std::memcpy(out.p + out.n, lits.data() + lit, static_cast<size_t>(llen));
    out.n += llen;
    lit += llen;
    if (off == 0 || off > static_cast<uint64_t>(out.n - frame_start))
      fail("match offset before the frame's start");
    uint8_t* dst = out.p + out.n;
    const uint8_t* src = dst - off;
    if (off >= static_cast<uint64_t>(mlen)) {
      std::memcpy(dst, src, static_cast<size_t>(mlen));
    } else {
      for (int64_t k = 0; k < mlen; ++k) dst[k] = src[k];
    }
    out.n += mlen;
  }
  if (bits.pos != 0) fail("sequences bitstream not consumed exactly");
  out.need(nlits - lit);
  std::memcpy(out.p + out.n, lits.data() + lit,
              static_cast<size_t>(nlits - lit));
  out.n += nlits - lit;
}

int64_t frame(const uint8_t* s, int64_t n, int64_t pos, Out& out) {
  if (pos >= n) fail("truncated frame header");
  const int fhd = s[pos++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
  if (fhd & 8) fail("reserved bit set in the frame header");
  const int checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  if (!single) ++pos;
  static const int ds[4] = {0, 1, 2, 4};
  const int dsize = ds[dict_flag];
  if (pos + dsize > n) fail("truncated frame header");
  if (dsize && load_le(s + pos, dsize)) fail("frame needs a dictionary");
  pos += dsize;
  const int fs[4] = {single ? 1 : 0, 2, 4, 8};
  const int fsize = fs[fcs_flag];
  if (pos + fsize > n) fail("truncated frame header");
  int64_t content = -1;
  if (fsize) {
    content = static_cast<int64_t>(load_le(s + pos, fsize)) +
              (fsize == 2 ? 256 : 0);
  }
  pos += fsize;
  const int64_t start = out.n;
  Frame fr;
  for (;;) {
    if (pos + 3 > n) fail("truncated block header");
    const uint32_t h = static_cast<uint32_t>(load_le(s + pos, 3));
    pos += 3;
    const int last = h & 1, kind = (h >> 1) & 3;
    const int64_t size = h >> 3;
    if (kind == 1) {
      if (pos >= n) fail("truncated RLE block");
      if (size > kBlockMax) fail("block over 128 KB");
      out.need(size);
      std::memset(out.p + out.n, s[pos], static_cast<size_t>(size));
      out.n += size;
      pos += 1;
    } else {
      if (pos + size > n) fail("truncated block");
      if (kind == 0) {
        if (size > kBlockMax) fail("block over 128 KB");
        out.need(size);
        std::memcpy(out.p + out.n, s + pos, static_cast<size_t>(size));
        out.n += size;
      } else if (kind == 2) {
        if (size == 0 || size > kBlockMax)
          fail("compressed block of a bad size");
        const int64_t before = out.n;
        block(s + pos, size, fr, out, start);
        if (out.n - before > kBlockMax) fail("block decodes to over 128 KB");
      } else {
        fail("reserved block type");
      }
      pos += size;
    }
    if (last) break;
  }
  if (content >= 0 && out.n - start != content)
    fail("frame decodes to another size than its header says");
  if (checksum) {
    if (pos + 4 > n) fail("truncated content checksum");
    const uint32_t want = static_cast<uint32_t>(load_le(s + pos, 4));
    if ((xxh64(out.p + start, out.n - start) & 0xFFFFFFFFull) != want)
      fail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

thread_local std::string last_error;

}  // namespace

extern "C" {

// The message of this thread's last failed call.
const char* qpzstd_last_error() { return last_error.c_str(); }

// Decode the concatenated frames at src[0:n] into dst[0:cap]: the bytes
// written, -1 on malformed input (see qpzstd_last_error), or -2 when dst is
// too small.
int64_t qpzstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t cap) {
  try {
    if (n <= 0) fail("empty input");
    Out out{dst, cap};
    int64_t pos = 0;
    while (pos < n) {
      if (pos + 4 > n) fail("truncated frame magic");
      const uint32_t magic = static_cast<uint32_t>(load_le(src + pos, 4));
      if (magic == kMagic) {
        pos = frame(src, n, pos + 4, out);
      } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (pos + 8 > n) fail("truncated skippable frame");
        pos += 8 + static_cast<int64_t>(load_le(src + pos + 4, 4));
        if (pos > n) fail("truncated skippable frame");
      } else {
        fail("not a zstd frame");
      }
    }
    return out.n;
  } catch (const TooSmall&) {
    return -2;
  } catch (const std::exception& e) {
    last_error = e.what();
    return -1;
  }
}

}  // extern "C"
