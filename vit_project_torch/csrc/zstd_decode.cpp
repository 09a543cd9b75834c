// A Zstandard decoder (RFC 8878), host C++ with a plain C interface.
//
// The orbax checkpoints the JAX package writes keep every array chunk as a
// zstd frame (zarr v2 "compressor": {"id": "zstd"}) and the OCDBT manifest
// and B-tree nodes as zstd bodies; this file decodes them without the
// system's libzstd. It covers what the format allows without a dictionary:
// frames (single-segment or windowed, with or without the content size and
// the XXH64 content checksum), skippable frames, several frames one after
// another, Raw / RLE / Compressed blocks, literals as Raw, RLE, Huffman
// (one or four streams; weights direct or FSE-compressed) or Treeless, and
// sequences with predefined, RLE, FSE-compressed and repeated tables and the
// three repeat offsets. A frame with a nonzero dictionary ID is refused.
//
// Every read of the input and every write of the output is bounds-checked:
// malformed input returns an error code, never reads or writes outside the
// buffers it was given.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -o libzstd_decode.so zstd_decode.cpp

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

enum Err : int {
  kOk = 0,
  kTruncated = 1,          // the input ends inside a frame
  kBadMagic = 2,           // neither a zstd nor a skippable frame
  kReservedBit = 3,        // a reserved bit or block type is set
  kDictionary = 4,         // the frame needs a dictionary
  kWindowTooLarge = 5,     // the window exceeds what this decoder accepts
  kCorruptBlock = 6,       // a block breaks its own size rules
  kDstTooSmall = 7,        // the output buffer is too small
  kChecksum = 8,           // the content checksum does not match
  kCorruptLiterals = 9,    // the literals section is malformed
  kCorruptHuffman = 10,    // the Huffman tree description is malformed
  kCorruptFse = 11,        // an FSE table description is malformed
  kCorruptSequences = 12,  // the sequences section is malformed
  kBadOffset = 13,         // a match reaches before the frame's start
  kContentSize = 14,       // the decoded size differs from the header's
};

const char* const kErrNames[] = {
    "ok",
    "input truncated inside a frame",
    "not a zstd frame (bad magic number)",
    "reserved bit or block type set",
    "frame needs a dictionary (not supported)",
    "window size too large",
    "corrupt block",
    "output buffer too small",
    "content checksum mismatch",
    "corrupt literals section",
    "corrupt Huffman tree description",
    "corrupt FSE table description",
    "corrupt sequences section",
    "match offset before the start of the frame",
    "decoded size differs from the frame content size",
};

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr size_t kBlockMax = 128 * 1024;
constexpr uint64_t kWindowMax = uint64_t(1) << 31;  // window log 31

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) { return rd16(p) | (rd16(p + 2) << 16); }
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // little-endian hosts (x86-64, aarch64)
  return v;
}
inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// What the decoder met, counted per thread (vp_zstd_stats): lets a test show
// that its corpus reached every block type, literals form and table mode.
enum Stat : int {
  kStatRawBlock, kStatRleBlock, kStatCompressedBlock,
  kStatLitRaw, kStatLitRle, kStatLitHuf1, kStatLitHuf4, kStatLitTreeless,
  kStatHufDirect, kStatHufFse,
  kStatSeqPredefined, kStatSeqRle, kStatSeqFse, kStatSeqRepeat,
  kStatChecksum, kStatSkippable, kStatFrame,
  kStatCount
};
thread_local uint64_t g_stats[kStatCount];
inline void tally(Stat s) { ++g_stats[s]; }

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 11400714785074694791ull;
constexpr uint64_t P2 = 14029467366897019727ull;
constexpr uint64_t P3 = 1609587929392839161ull;
constexpr uint64_t P4 = 9650029242287828579ull;
constexpr uint64_t P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}
inline uint64_t xxmerge(uint64_t acc, uint64_t v) {
  acc ^= xxround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxround(v1, rd64(p));
      v2 = xxround(v2, rd64(p + 8));
      v3 = xxround(v3, rd64(p + 16));
      v4 = xxround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxmerge(h, v1);
    h = xxmerge(h, v2);
    h = xxmerge(h, v3);
    h = xxmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(len);
  while (p + 8 <= end) {
    h ^= xxround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------ backward bit reader
//
// zstd's entropy streams are read from their last byte towards the first; the
// highest set bit of the last byte marks the start. `consumed` counts the bits
// taken from the top of the 64-bit window at `ptr`; past the first byte the
// reader yields zeros and `consumed` keeps growing, so an overread is seen at
// the end (overflowed()) and never reads memory outside the stream.

struct BitBack {
  uint64_t bits = 0;
  unsigned consumed = 0;
  const uint8_t* ptr = nullptr;
  const uint8_t* start = nullptr;

  bool init(const uint8_t* src, size_t size) {
    if (size < 1) return false;
    uint8_t last = src[size - 1];
    if (last == 0) return false;
    start = src;
    if (size >= 8) {
      ptr = src + size - 8;
      bits = rd64(ptr);
      consumed = 8 - highbit32(last);
    } else {
      ptr = src;
      bits = 0;
      for (size_t i = 0; i < size; ++i) bits |= uint64_t(src[i]) << (8 * i);
      consumed = 8 - highbit32(last) + unsigned(8 - size) * 8;
    }
    return true;
  }
  // the next n bits (n <= 57 after a reload), without taking them
  inline uint64_t look(unsigned n) const {
    if (n == 0) return 0;
    return ((bits << (consumed & 63)) >> 1) >> (63 - n);
  }
  inline void skip(unsigned n) { consumed += n; }
  inline uint64_t read(unsigned n) {
    uint64_t v = look(n);
    consumed += n;
    return v;
  }
  // refill the window; afterwards at least 57 bits are available unless the
  // stream's start is near
  inline void reload() {
    if (consumed > 64) return;  // overflowed: stays so
    if (ptr >= start + 8) {
      ptr -= consumed >> 3;
      consumed &= 7;
      bits = rd64(ptr);
      return;
    }
    if (ptr == start) return;
    size_t nb = consumed >> 3;
    if (size_t(ptr - start) < nb) nb = size_t(ptr - start);
    ptr -= nb;
    consumed -= unsigned(nb * 8);
    bits = rd64(ptr);
  }
  bool overflowed() const { return consumed > 64; }
  // every bit taken, none past the start
  bool finished() const { return ptr == start && consumed == 64; }
};

// ------------------------------------------------------------- FSE tables

struct FseEntry {
  uint16_t next;  // base of the next state
  uint8_t symbol;
  uint8_t nbits;
};

constexpr int kMaxFseLog = 9;

struct FseTable {
  FseEntry e[1 << kMaxFseLog];
  int log = 0;
  bool valid = false;
};

// Read an FSE table description (forward, little-endian bits) from src.
// Returns the bytes it took, or 0 on error. norm gets max_symbol+1 counts.
size_t read_ncount(const uint8_t* src, size_t size, int16_t* norm,
                   int* max_symbol, int* log, int max_log) {
  // a forward bit reader with zeros past the end; overrun is an error
  uint64_t pos = 0;  // in bits
  const uint64_t total = uint64_t(size) * 8;
  auto peek = [&](unsigned n) -> uint32_t {
    uint32_t v = 0;
    for (unsigned i = 0; i < n; ++i) {
      uint64_t b = pos + i;
      if (b < total && ((src[b >> 3] >> (b & 7)) & 1)) v |= 1u << i;
    }
    return v;
  };
  if (size < 1) return 0;
  int acc = int(peek(4)) + 5;
  pos += 4;
  if (acc > max_log) return 0;
  *log = acc;
  int remaining = (1 << acc) + 1;
  int threshold = 1 << acc;
  int nbits = acc + 1;
  int sym = 0;
  const int limit = *max_symbol;  // largest symbol allowed
  for (int i = 0; i <= limit; ++i) norm[i] = 0;
  bool previous0 = false;
  while (remaining > 1) {
    if (previous0) {
      for (;;) {
        uint32_t r = peek(2);
        pos += 2;
        sym += int(r);
        if (sym > limit + 1) return 0;
        if (r != 3) break;
      }
      if (sym > limit) return 0;
    }
    if (sym > limit) return 0;
    int max = (2 * threshold - 1) - remaining;
    uint32_t bits = peek(unsigned(nbits));
    int count;
    if (int(bits & uint32_t(threshold - 1)) < max) {
      count = int(bits & uint32_t(threshold - 1));
      pos += unsigned(nbits - 1);
    } else {
      count = int(bits & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= max;
      pos += unsigned(nbits);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    previous0 = (count == 0);
    if (remaining < 1) return 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
    if (pos > total) return 0;
  }
  if (remaining != 1 || pos > total) return 0;
  *max_symbol = sym - 1;
  return size_t((pos + 7) >> 3);
}

// Build the decoding table from normalized counts (RFC 8878 4.1.1).
bool build_fse(FseTable* t, const int16_t* norm, int max_symbol, int log) {
  const int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  uint8_t sym_at[1 << kMaxFseLog];
  int total = 0;
  for (int s = 0; s <= max_symbol; ++s) {
    if (norm[s] == -1) {
      if (high < 0) return false;
      sym_at[high--] = uint8_t(s);
      next[s] = 1;
      total += 1;
    } else {
      if (norm[s] < 0) return false;
      next[s] = uint16_t(norm[s]);
      total += norm[s];
    }
  }
  if (total != size) return false;
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int pos = 0;
  for (int s = 0; s <= max_symbol; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      sym_at[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) return false;
  for (int u = 0; u < size; ++u) {
    int s = sym_at[u];
    uint32_t ns = next[s]++;
    int nb = log - highbit32(ns);
    t->e[u].symbol = uint8_t(s);
    t->e[u].nbits = uint8_t(nb);
    t->e[u].next = uint16_t((ns << nb) - uint32_t(size));
  }
  t->log = log;
  t->valid = true;
  return true;
}

void build_rle(FseTable* t, uint8_t symbol) {
  t->e[0].symbol = symbol;
  t->e[0].nbits = 0;
  t->e[0].next = 0;
  t->log = 0;
  t->valid = true;
}

// ----------------------------------------------------------------- Huffman

constexpr int kMaxHufLog = 11;

struct HufEntry {
  uint8_t symbol;
  uint8_t nbits;
};

struct HufTable {
  HufEntry e[1 << kMaxHufLog];
  int log = 0;
  bool valid = false;
};

// Decode the Huffman weights, FSE-compressed (two interleaved states).
// Returns the number of weights, or -1.
int fse_weights(const uint8_t* src, size_t size, uint8_t* w) {
  int16_t norm[256];
  int max_symbol = 255, log = 0;
  size_t hdr = read_ncount(src, size, norm, &max_symbol, &log, 6);
  if (hdr == 0 || hdr > size) return -1;
  static thread_local FseTable t;
  if (!build_fse(&t, norm, max_symbol, log)) return -1;
  BitBack br;
  if (!br.init(src + hdr, size - hdr)) return -1;
  uint32_t s1 = uint32_t(br.read(unsigned(log)));
  uint32_t s2 = uint32_t(br.read(unsigned(log)));
  br.reload();
  int n = 0;
  const int cap = 255;
  for (;;) {
    if (n > cap - 2) return -1;
    FseEntry e = t.e[s1];
    w[n++] = e.symbol;
    s1 = e.next + uint32_t(br.read(e.nbits));
    br.reload();
    if (br.overflowed()) {
      w[n++] = t.e[s2].symbol;
      break;
    }
    if (n > cap - 2) return -1;
    e = t.e[s2];
    w[n++] = e.symbol;
    s2 = e.next + uint32_t(br.read(e.nbits));
    br.reload();
    if (br.overflowed()) {
      w[n++] = t.e[s1].symbol;
      break;
    }
  }
  return n;
}

// Read a Huffman tree description; returns the bytes it took, or 0.
size_t read_huffman(const uint8_t* src, size_t size, HufTable* t) {
  if (size < 1) return 0;
  uint8_t w[256];
  int n;
  size_t used;
  uint8_t hb = src[0];
  if (hb < 128) {
    if (size_t(hb) + 1 > size || hb == 0) return 0;
    n = fse_weights(src + 1, hb, w);
    if (n < 0) return 0;
    used = 1 + size_t(hb);
    tally(kStatHufFse);
  } else {
    n = hb - 127;
    size_t bytes = (size_t(n) + 1) / 2;
    if (1 + bytes > size) return 0;
    for (int i = 0; i < n; ++i) {
      uint8_t b = src[1 + i / 2];
      w[i] = (i % 2 == 0) ? uint8_t(b >> 4) : uint8_t(b & 15);
    }
    used = 1 + bytes;
    tally(kStatHufDirect);
  }
  if (n > 255) return 0;
  // the last weight is implied: the sum of 2^(w-1) completes a power of two
  uint32_t sum = 0;
  for (int i = 0; i < n; ++i) {
    if (w[i] > kMaxHufLog) return 0;
    if (w[i]) sum += 1u << (w[i] - 1);
  }
  if (sum == 0) return 0;
  int maxbits = highbit32(sum) + 1;
  if (maxbits > kMaxHufLog) return 0;
  uint32_t rest = (1u << maxbits) - sum;
  if (rest == 0 || (rest & (rest - 1))) return 0;
  w[n++] = uint8_t(highbit32(rest) + 1);
  // canonical codes: lower weights take the lower table slots, symbols of
  // one weight in increasing order
  uint32_t count[kMaxHufLog + 2] = {0};
  for (int i = 0; i < n; ++i) count[w[i]]++;
  uint32_t start[kMaxHufLog + 2] = {0};
  uint32_t at = 0;
  for (int wt = 1; wt <= maxbits; ++wt) {
    start[wt] = at;
    at += count[wt] << (wt - 1);
  }
  if (at != (1u << maxbits)) return 0;
  for (int s = 0; s < n; ++s) {
    int wt = w[s];
    if (!wt) continue;
    uint32_t len = 1u << (wt - 1);
    HufEntry e{uint8_t(s), uint8_t(maxbits + 1 - wt)};
    for (uint32_t j = 0; j < len; ++j) t->e[start[wt] + j] = e;
    start[wt] += len;
  }
  t->log = maxbits;
  t->valid = true;
  return used;
}

inline uint8_t huf_symbol(const HufTable& t, BitBack& br) {
  HufEntry e = t.e[br.look(unsigned(t.log))];
  br.skip(e.nbits);
  return e.symbol;
}

// The rest of one Huffman stream, [op, end), from the reader's state; true
// when the stream ends exactly with its last symbol.
bool huf_finish(const HufTable& t, BitBack& br, uint8_t* op,
                uint8_t* const end) {
  // four symbols a refill while the window holds them
  while (end - op >= 4) {
    br.reload();
    if (br.consumed > 64 - 4 * kMaxHufLog) break;
    for (int k = 0; k < 4; ++k) *op++ = huf_symbol(t, br);
  }
  while (op < end) {
    br.reload();
    *op++ = huf_symbol(t, br);
  }
  br.reload();
  return br.finished();
}

// Decode one Huffman stream of exactly `count` symbols into dst.
bool huf_stream(const HufTable& t, const uint8_t* src, size_t size,
                uint8_t* dst, size_t count) {
  BitBack br;
  if (!br.init(src, size)) return false;
  return huf_finish(t, br, dst, dst + count);
}

// The four streams of a literals section, interleaved: one refill of each
// reader, then four symbols from each, while every window holds four
// symbols and every stream has four to write; then each stream's rest.
bool huf_4streams(const HufTable& t, const uint8_t* const src[4],
                  const size_t size[4], uint8_t* const dst[4],
                  const size_t count[4]) {
  BitBack br[4];
  uint8_t* op[4];
  uint8_t* end[4];
  for (int k = 0; k < 4; ++k) {
    if (!br[k].init(src[k], size[k])) return false;
    op[k] = dst[k];
    end[k] = dst[k] + count[k];
  }
  for (;;) {
    bool room = true;
    for (int k = 0; k < 4; ++k) {
      br[k].reload();
      room &= br[k].consumed <= 64 - 4 * kMaxHufLog && end[k] - op[k] >= 4;
    }
    if (!room) break;
    for (int j = 0; j < 4; ++j) {
      op[0][j] = huf_symbol(t, br[0]);
      op[1][j] = huf_symbol(t, br[1]);
      op[2][j] = huf_symbol(t, br[2]);
      op[3][j] = huf_symbol(t, br[3]);
    }
    for (int k = 0; k < 4; ++k) op[k] += 4;
  }
  for (int k = 0; k < 4; ++k)
    if (!huf_finish(t, br[k], op[k], end[k])) return false;
  return true;
}

// ------------------------------------------------------------ the decoder

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  FseTable ll, of, ml;
  HufTable huf;
  uint32_t rep[3];
  uint64_t window;
  uint8_t literals[kBlockMax];
  void reset(uint64_t w) {
    ll.valid = of.valid = ml.valid = false;
    huf.valid = false;
    rep[0] = 1;
    rep[1] = 4;
    rep[2] = 8;
    window = w;
  }
};

// The literals section: fills st->literals, sets *nlit; returns bytes taken
// or 0 on error.
size_t decode_literals(FrameState* st, const uint8_t* src, size_t size,
                       size_t* nlit) {
  if (size < 1) return 0;
  const int type = src[0] & 3;
  const int sf = (src[0] >> 2) & 3;
  if (type == 0 || type == 1) {  // Raw, RLE
    size_t hdr, regen;
    if (sf == 0 || sf == 2) {
      hdr = 1;
      regen = src[0] >> 3;
    } else if (sf == 1) {
      if (size < 2) return 0;
      hdr = 2;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      if (size < 3) return 0;
      hdr = 3;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
    if (regen > kBlockMax) return 0;
    tally(type == 0 ? kStatLitRaw : kStatLitRle);
    if (type == 0) {
      if (hdr + regen > size) return 0;
      std::memcpy(st->literals, src + hdr, regen);
      *nlit = regen;
      return hdr + regen;
    }
    if (hdr + 1 > size) return 0;
    std::memset(st->literals, src[hdr], regen);
    *nlit = regen;
    return hdr + 1;
  }
  // Compressed (2) or Treeless (3)
  size_t hdr, regen, csize;
  bool four = sf != 0;
  if (sf == 0 || sf == 1) {
    if (size < 3) return 0;
    uint32_t c = rd24(src);
    hdr = 3;
    regen = (c >> 4) & 0x3FF;
    csize = (c >> 14) & 0x3FF;
  } else if (sf == 2) {
    if (size < 4) return 0;
    uint32_t c = rd32(src);
    hdr = 4;
    regen = (c >> 4) & 0x3FFF;
    csize = (c >> 18) & 0x3FFF;
  } else {
    if (size < 5) return 0;
    uint64_t c = rd32(src) | (uint64_t(src[4]) << 32);
    hdr = 5;
    regen = size_t((c >> 4) & 0x3FFFF);
    csize = size_t((c >> 22) & 0x3FFFF);
  }
  if (regen > kBlockMax || hdr + csize > size) return 0;
  const uint8_t* p = src + hdr;
  size_t left = csize;
  if (type == 2) {
    size_t used = read_huffman(p, left, &st->huf);
    if (used == 0) {
      st->huf.valid = false;
      return 0;
    }
    p += used;
    left -= used;
  } else if (!st->huf.valid) {
    return 0;
  }
  tally(type == 3 ? kStatLitTreeless : four ? kStatLitHuf4 : kStatLitHuf1);
  if (!four) {
    if (!huf_stream(st->huf, p, left, st->literals, regen)) return 0;
  } else {
    if (left < 6 || regen < 4) return 0;
    size_t s1 = rd16(p), s2 = rd16(p + 2), s3 = rd16(p + 4);
    p += 6;
    left -= 6;
    if (s1 + s2 + s3 > left) return 0;
    size_t s4 = left - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    size_t last = regen - 3 * seg;
    if (regen < 3 * seg) return 0;
    const size_t sz[4] = {s1, s2, s3, s4};
    const size_t n[4] = {seg, seg, seg, last};
    const uint8_t* const in[4] = {p, p + s1, p + s1 + s2, p + s1 + s2 + s3};
    uint8_t* const out[4] = {st->literals, st->literals + seg,
                             st->literals + 2 * seg, st->literals + 3 * seg};
    if (!huf_4streams(st->huf, in, sz, out, n)) return 0;
  }
  *nlit = regen;
  return hdr + csize;
}

// One table of the sequences section; returns bytes taken, or SIZE_MAX.
size_t read_seq_table(FseTable* t, int mode, const uint8_t* src, size_t size,
                      const int16_t* def, int def_max, int def_log,
                      int max_symbol, int max_log) {
  tally(Stat(kStatSeqPredefined + mode));
  switch (mode) {
    case 0: {
      int16_t norm[64];
      for (int i = 0; i <= def_max; ++i) norm[i] = def[i];
      if (!build_fse(t, norm, def_max, def_log)) return SIZE_MAX;
      return 0;
    }
    case 1:
      if (size < 1 || src[0] > max_symbol) return SIZE_MAX;
      build_rle(t, src[0]);
      return 1;
    case 2: {
      int16_t norm[256];
      int ms = max_symbol, lg = 0;
      size_t used = read_ncount(src, size, norm, &ms, &lg, max_log);
      if (used == 0 || used > size) return SIZE_MAX;
      if (!build_fse(t, norm, ms, lg)) return SIZE_MAX;
      return used;
    }
    default:
      if (!t->valid) return SIZE_MAX;
      return 0;
  }
}

// A compressed block's content into dst[*op ..cap), the frame starting at
// fstart. Returns kOk or an error.
int decode_compressed(FrameState* st, const uint8_t* src, size_t size,
                      uint8_t* dst, size_t cap, size_t fstart, size_t* op) {
  size_t nlit = 0;
  size_t used = decode_literals(st, src, size, &nlit);
  if (used == 0) return kCorruptLiterals;
  const uint8_t* p = src + used;
  size_t left = size - used;
  if (left < 1) return kCorruptSequences;
  size_t nseq = p[0];
  if (nseq < 128) {
    p += 1;
    left -= 1;
  } else if (nseq < 255) {
    if (left < 2) return kCorruptSequences;
    nseq = ((nseq - 128) << 8) + p[1];
    p += 2;
    left -= 2;
  } else {
    if (left < 3) return kCorruptSequences;
    nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
    p += 3;
    left -= 3;
  }
  size_t o = *op;
  const size_t block_start = o;
  const uint8_t* lit = st->literals;
  const uint8_t* lit_end = st->literals + nlit;
  if (nseq == 0) {
    if (left != 0) return kCorruptSequences;
    if (nlit > cap - o) return kDstTooSmall;
    std::memcpy(dst + o, lit, nlit);
    *op = o + nlit;
    return kOk;
  }
  if (left < 1) return kCorruptSequences;
  const uint8_t modes = p[0];
  if (modes & 3) return kReservedBit;
  p += 1;
  left -= 1;
  size_t u = read_seq_table(&st->ll, modes >> 6, p, left, kLLDefault, 35, 6,
                            35, 9);
  if (u == SIZE_MAX) return kCorruptFse;
  p += u;
  left -= u;
  u = read_seq_table(&st->of, (modes >> 4) & 3, p, left, kOFDefault, 28, 5,
                     31, 8);
  if (u == SIZE_MAX) return kCorruptFse;
  p += u;
  left -= u;
  u = read_seq_table(&st->ml, (modes >> 2) & 3, p, left, kMLDefault, 52, 6,
                     52, 9);
  if (u == SIZE_MAX) return kCorruptFse;
  p += u;
  left -= u;

  BitBack br;
  if (!br.init(p, left)) return kCorruptSequences;
  uint32_t sll = uint32_t(br.read(unsigned(st->ll.log)));
  br.reload();
  uint32_t sof = uint32_t(br.read(unsigned(st->of.log)));
  br.reload();
  uint32_t sml = uint32_t(br.read(unsigned(st->ml.log)));
  br.reload();
  uint32_t* rep = st->rep;
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry& ell = st->ll.e[sll];
    const FseEntry& eof = st->of.e[sof];
    const FseEntry& eml = st->ml.e[sml];
    const unsigned llc = ell.symbol, ofc = eof.symbol, mlc = eml.symbol;
    if (llc > 35 || mlc > 52 || ofc > 31) return kCorruptSequences;
    // extra bits: offset, then match length, then literals length
    uint32_t ofv = (1u << ofc) + uint32_t(br.read(ofc));
    br.reload();
    size_t ml = kMLBase[mlc] + size_t(br.read(kMLBits[mlc]));
    br.reload();
    size_t ll = kLLBase[llc] + size_t(br.read(kLLBits[llc]));
    br.reload();
    size_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = uint32_t(offset);
    } else {
      unsigned idx = ofv - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = (idx == 3) ? size_t(rep[0]) - 1 : rep[idx];
        if (offset == 0) return kCorruptSequences;
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(offset);
      }
    }
    if (i + 1 < nseq) {  // state updates: literals length, match, offset
      sll = ell.next + uint32_t(br.read(ell.nbits));
      sml = eml.next + uint32_t(br.read(eml.nbits));
      sof = eof.next + uint32_t(br.read(eof.nbits));
      br.reload();
    }
    // execute: ll literals, then ml bytes from offset back
    if (ll > size_t(lit_end - lit)) return kCorruptSequences;
    if (ll > cap - o) return kDstTooSmall;
    std::memcpy(dst + o, lit, ll);
    o += ll;
    lit += ll;
    if (offset > o - fstart || offset > st->window) return kBadOffset;
    if (ml > cap - o) return kDstTooSmall;
    uint8_t* d = dst + o;
    const uint8_t* s = d - offset;
    if (offset >= ml) {
      std::memcpy(d, s, ml);
    } else if (offset >= 8) {
      size_t k = 0;
      for (; k + 8 <= ml; k += 8) std::memcpy(d + k, s + k, 8);
      for (; k < ml; ++k) d[k] = s[k];
    } else {
      for (size_t k = 0; k < ml; ++k) d[k] = s[k];
    }
    o += ml;
    if (o - block_start > kBlockMax) return kCorruptBlock;
  }
  if (!br.finished()) return kCorruptSequences;
  size_t rest = size_t(lit_end - lit);
  if (rest > cap - o) return kDstTooSmall;
  std::memcpy(dst + o, lit, rest);
  o += rest;
  if (o - block_start > kBlockMax) return kCorruptBlock;
  *op = o;
  return kOk;
}

// One zstd frame at src[0..size); on success *taken is its length.
int decode_frame(FrameState* st, const uint8_t* src, size_t size,
                 uint8_t* dst, size_t cap, size_t* op, size_t* taken) {
  if (size < 5) return kTruncated;
  const uint8_t fhd = src[4];
  const int fcs_flag = fhd >> 6;
  const bool single = (fhd >> 5) & 1;
  const bool checksum = (fhd >> 2) & 1;
  const int did_flag = fhd & 3;
  if (fhd & 8) return kReservedBit;
  size_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    if (pos + 1 > size) return kTruncated;
    const uint8_t wd = src[pos++];
    const int exponent = wd >> 3, mantissa = wd & 7;
    const int wlog = 10 + exponent;
    if (wlog > 31) return kWindowTooLarge;
    const uint64_t base = uint64_t(1) << wlog;
    window = base + (base / 8) * uint64_t(mantissa);
  }
  static const int kDidBytes[4] = {0, 1, 2, 4};
  const int did_bytes = kDidBytes[did_flag];
  if (pos + size_t(did_bytes) > size) return kTruncated;
  uint32_t did = 0;
  for (int i = 0; i < did_bytes; ++i) did |= uint32_t(src[pos + i]) << (8 * i);
  pos += size_t(did_bytes);
  if (did != 0) return kDictionary;
  static const int kFcsBytes[4] = {0, 2, 4, 8};
  int fcs_bytes = kFcsBytes[fcs_flag];
  if (fcs_flag == 0 && single) fcs_bytes = 1;
  bool has_fcs = fcs_bytes > 0;
  uint64_t fcs = 0;
  if (pos + size_t(fcs_bytes) > size) return kTruncated;
  for (int i = 0; i < fcs_bytes; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
  if (fcs_bytes == 2) fcs += 256;
  pos += size_t(fcs_bytes);
  if (single) window = fcs;
  if (window > kWindowMax) return kWindowTooLarge;
  if (has_fcs && fcs > cap - *op) return kDstTooSmall;
  st->reset(window);
  tally(kStatFrame);
  const size_t block_max = window < kBlockMax ? size_t(window) : kBlockMax;
  const size_t fstart = *op;
  size_t o = *op;
  for (;;) {
    if (pos + 3 > size) return kTruncated;
    const uint32_t bh = rd24(src + pos);
    pos += 3;
    const bool last = bh & 1;
    const int btype = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (btype == 3) return kReservedBit;
    tally(Stat(kStatRawBlock + btype));
    if (btype == 1) {  // RLE: one byte, bsize times
      if (pos + 1 > size) return kTruncated;
      if (bsize > block_max) return kCorruptBlock;
      if (bsize > cap - o) return kDstTooSmall;
      std::memset(dst + o, src[pos], bsize);
      o += bsize;
      pos += 1;
    } else {
      if (bsize > size - pos) return kTruncated;
      if (bsize > block_max) return kCorruptBlock;
      if (btype == 0) {
        if (bsize > cap - o) return kDstTooSmall;
        std::memcpy(dst + o, src + pos, bsize);
        o += bsize;
      } else {
        int rc = decode_compressed(st, src + pos, bsize, dst, cap, fstart, &o);
        if (rc != kOk) return rc;
      }
      pos += bsize;
    }
    if (last) break;
  }
  if (has_fcs && o - fstart != fcs) return kContentSize;
  if (checksum) {
    if (pos + 4 > size) return kTruncated;
    const uint32_t want = rd32(src + pos);
    pos += 4;
    tally(kStatChecksum);
    if (uint32_t(xxh64(dst + fstart, o - fstart, 0)) != want) return kChecksum;
  }
  *op = o;
  *taken = pos;
  return kOk;
}

}  // namespace

extern "C" {

// Decode every frame in src[0..n) into dst[0..cap). On success returns 0 and
// sets *out_len; on failure returns an error code (see vp_zstd_error_name)
// and sets *err_pos to the byte offset of the frame at fault.
int vp_zstd_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                   size_t* out_len, size_t* err_pos) {
  static thread_local FrameState* st = nullptr;
  if (!st) st = new FrameState();
  size_t pos = 0, o = 0;
  *out_len = 0;
  *err_pos = 0;
  while (pos < n) {
    *err_pos = pos;
    if (n - pos < 4) return kTruncated;
    const uint32_t magic = rd32(src + pos);
    if ((magic & kSkippableMask) == kSkippableMagic) {
      if (n - pos < 8) return kTruncated;
      const size_t len = rd32(src + pos + 4);
      if (len > n - pos - 8) return kTruncated;
      pos += 8 + len;
      tally(kStatSkippable);
      continue;
    }
    if (magic != kMagic) return kBadMagic;
    size_t taken = 0;
    int rc = decode_frame(st, src + pos, n - pos, dst, cap, &o, &taken);
    if (rc != kOk) return rc;
    pos += taken;
  }
  *out_len = o;
  return kOk;
}

// The sum of the frames' content sizes when every frame states its size;
// -1 when one does not; -2 when the headers are malformed.
long long vp_zstd_content_size(const uint8_t* src, size_t n) {
  size_t pos = 0;
  unsigned long long total = 0;
  while (pos < n) {
    if (n - pos < 4) return -2;
    const uint32_t magic = rd32(src + pos);
    if ((magic & kSkippableMask) == kSkippableMagic) {
      if (n - pos < 8) return -2;
      const size_t len = rd32(src + pos + 4);
      if (len > n - pos - 8) return -2;
      pos += 8 + len;
      continue;
    }
    if (magic != kMagic || n - pos < 5) return -2;
    const uint8_t fhd = src[pos + 4];
    const int fcs_flag = fhd >> 6;
    const bool single = (fhd >> 5) & 1;
    static const int kDidBytes[4] = {0, 1, 2, 4};
    static const int kFcsBytes[4] = {0, 2, 4, 8};
    int fcs_bytes = kFcsBytes[fcs_flag];
    if (fcs_flag == 0 && single) fcs_bytes = 1;
    if (fcs_bytes == 0) return -1;
    size_t at = pos + 5 + (single ? 0 : 1) + size_t(kDidBytes[fhd & 3]);
    if (at + size_t(fcs_bytes) > n) return -2;
    unsigned long long fcs = 0;
    for (int i = 0; i < fcs_bytes; ++i)
      fcs |= (unsigned long long)(src[at + i]) << (8 * i);
    if (fcs_bytes == 2) fcs += 256;
    total += fcs;
    // walk the blocks to the frame's end
    size_t p = at + size_t(fcs_bytes);
    for (;;) {
      if (p + 3 > n) return -2;
      const uint32_t bh = rd24(src + p);
      p += 3;
      const int btype = (bh >> 1) & 3;
      const size_t bsize = bh >> 3;
      const size_t len = btype == 1 ? 1 : bsize;
      if (btype == 3 || len > n - p) return -2;
      p += len;
      if (bh & 1) break;
    }
    if ((fhd >> 2) & 1) p += 4;
    if (p > n) return -2;
    pos = p;
  }
  if (total > (unsigned long long)(1ull << 62)) return -2;
  return (long long)total;
}

const char* vp_zstd_error_name(int code) {
  if (code < 0 || code >= int(sizeof(kErrNames) / sizeof(kErrNames[0])))
    return "unknown error";
  return kErrNames[code];
}

// Copy this thread's counts (kStatCount of them, in the order of enum Stat)
// into out[0..n) and set them to zero; returns kStatCount.
int vp_zstd_stats(uint64_t* out, int n) {
  for (int i = 0; i < kStatCount; ++i) {
    if (i < n) out[i] = g_stats[i];
    g_stats[i] = 0;
  }
  return kStatCount;
}

}  // extern "C"
