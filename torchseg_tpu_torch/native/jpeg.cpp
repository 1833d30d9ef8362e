// A JPEG decoder for the port's image reader (data/image_io.py), bound with
// ctypes (torchseg_tpu_torch/native/__init__.py).
//
// It gives what cv2.imread gives through libjpeg-turbo with its defaults:
// the integer "slow" inverse DCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2,
// the output clamped to 0..255), fancy (triangle) upsampling of h2v1,
// h2v2 and h1v2 chroma (jdsample.c; replication for the other integral
// ratios, and for h2v1 / h2v2 planes two samples wide or less), and the
// 16-bit fixed-point YCbCr -> RGB tables of jdcolor.c.  GRAYSCALE of a
// colour file is its Y plane (libjpeg's grayscale_convert), of an RGB one
// jdcolor.c's rgb_gray_convert; COLOR of a grey file replicates it.
//
// Decoded: baseline and extended Huffman (SOF0, SOF1) and progressive
// Huffman (SOF2) files of 8-bit precision with one or three components,
// restart intervals, 8- and 16-bit quantization tables.  Every scan decodes
// into whole-image coefficient arrays, which are dequantized and inverse
// transformed once the file has been read.  Past the end of the data (or
// at a marker inside a scan) the bit reader supplies zero bits, as
// libjpeg's source manager does; once such a bit has been consumed, the
// rest of the restart interval is left zero (libjpeg's
// insufficient_data), so a truncated baseline file decodes to the image
// libjpeg gives.  Progressive block smoothing (jdcoefct.c
// decompress_smooth_data) is not done: libjpeg applies it only while one of
// the first ten coefficients of some component is incomplete, which a
// complete file never is; a truncated progressive file where it would apply
// decodes unsmoothed and jpeg_decode returns 2.
//
// Refused (error message, return code 1): arithmetic coding, lossless and
// hierarchical files, 12-bit precision, two or four components.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for safety with corrupt data (jutils.c)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // 8-bit lookahead: (length << 8) | symbol, length 0 = longer code
  uint16_t look[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;          // blocks a row / column (width_in_blocks)
  int bw_alloc = 0, bh_alloc = 0;  // padded to whole MCUs
  int dw = 0, dh = 0;          // downsampled_width / height
  std::vector<int16_t> coef;   // bh_alloc * bw_alloc * 64, natural order
  int coef_bits[64];           // progressive: last Al seen, -1 none
  uint16_t quant[64];          // latched at its first scan
  bool latched = false;
  int last_dc = 0;
  std::vector<uint8_t> plane;  // bh * 8 rows of bw * 8 samples
};

class Decoder {
 public:
  Decoder(const uint8_t* data, long n) : d_(data), n_((size_t)n) {}

  // Parses the markers up to the first SOS (header only) or to the end.
  void run(bool header_only);
  int width = 0, height = 0;
  std::vector<Component> comps;
  int color_space() const;  // 1 grey, 2 YCbCr, 3 RGB
  void output(int mode, uint8_t* out);
  bool would_smooth() const;

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  uint16_t qt_[4][64];
  bool qt_set_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  bool progressive_ = false, have_sof_ = false, jfif_ = false;
  int adobe_ = -1;  // Adobe transform, -1 without an APP14 Adobe marker
  int restart_interval_ = 0;

  // bit reader (jdhuff.c's semantics)
  uint64_t acc_ = 0;
  int nbits_ = 0, nfake_ = 0;
  bool marker_hit_ = false;
  bool insufficient_ = false;
  int eobrun_ = 0;

  [[noreturn]] void fail(const std::string& m) { throw Error{m}; }
  int byte() {
    if (pos_ >= n_) fail("unexpected end of the JPEG header");
    return d_[pos_++];
  }
  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }
  int next_marker();
  void read_sof(int marker);
  void read_dqt();
  void read_dht();
  void read_sos();
  void skip_segment();
  void read_app(int marker);

  // entropy decoding
  void reset_bits() {
    acc_ = 0;
    nbits_ = nfake_ = 0;
  }
  void fill(int need);
  int get_bits(int n);
  int get_bit() { return get_bits(1); }
  int peek8();
  int decode(const Huffman& h);
  static int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
  }
  void process_restart();
  void decode_block_baseline(Component& c, int16_t* blk);
  void decode_dc_first(Component& c, int16_t* blk, int al);
  void decode_dc_refine(int16_t* blk, int al);
  void decode_ac_first(Component& c, int16_t* blk, int ss, int se, int al);
  void decode_ac_refine(Component& c, int16_t* blk, int ss, int se, int al);
  void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals,
                     int nvals);
  void idct_all();
  void upsample(const Component& c, std::vector<uint8_t>& out) const;
};

int Decoder::next_marker() {
  // libjpeg's next_marker: skip any non-FF bytes, then FF fill bytes
  for (;;) {
    if (pos_ >= n_) return -1;
    int c = d_[pos_++];
    if (c != 0xFF) continue;
    while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
    if (pos_ >= n_) return -1;
    c = d_[pos_++];
    if (c != 0) return c;
  }
}

void Decoder::skip_segment() {
  int len = u16();
  if (len < 2) fail("bad JPEG marker length");
  pos_ += (size_t)(len - 2);
  if (pos_ > n_) pos_ = n_;
}

void Decoder::read_app(int marker) {
  int len = u16();
  if (len < 2) fail("bad JPEG marker length");
  size_t start = pos_, end = std::min(n_, pos_ + (size_t)(len - 2));
  size_t dl = end - start;
  const uint8_t* p = d_ + start;
  if (marker == 0xE0 && dl >= 14 && memcmp(p, "JFIF\0", 5) == 0) jfif_ = true;
  if (marker == 0xEE && dl >= 12 && memcmp(p, "Adobe", 5) == 0)
    adobe_ = p[11];
  pos_ = end;
}

void Decoder::read_dqt() {
  int len = u16() - 2;
  while (len > 0) {
    int pq_tq = byte();
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3) fail("bad JPEG quantization table index");
    int count = 64;
    if (len < count * (pq ? 2 : 1) + 1) count = (len - 1) / (pq ? 2 : 1);
    for (int i = 0; i < 64; i++) qt_[tq][kNatural[i]] = 1;  // jdmarker.c
    for (int i = 0; i < count; i++)
      qt_[tq][kNatural[i]] = (uint16_t)(pq ? u16() : byte());
    qt_set_[tq] = true;
    len -= count * (pq ? 2 : 1) + 1;
  }
}

void Decoder::build_huffman(Huffman& h, const uint8_t* counts,
                            const uint8_t* vals, int nvals) {
  // jdhuff.c jpeg_make_d_derived_tbl
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < counts[l - 1]; i++) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) fail("bad JPEG Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (counts[l - 1]) {
      h.valoffset[l] = p - huffcode[p];
      p += counts[l - 1];
      h.maxcode[l] = huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0x7FFFFFFF;  // sentinel
  memset(h.vals, 0, sizeof(h.vals));
  memcpy(h.vals, vals, (size_t)nvals);
  memset(h.look, 0, sizeof(h.look));
  p = 0;
  for (int l = 1; l <= 8; l++) {
    for (int i = 1; i <= counts[l - 1]; i++, p++) {
      int lookbits = huffcode[p] << (8 - l);
      for (int ctr = 1 << (8 - l); ctr > 0; ctr--)
        h.look[lookbits++] = (uint16_t)((l << 8) | h.vals[p]);
    }
  }
  h.defined = true;
}

void Decoder::read_dht() {
  int len = u16() - 2;
  while (len > 16) {
    int index = byte();
    uint8_t counts[16], vals[256];
    int total = 0;
    for (int i = 0; i < 16; i++) {
      counts[i] = (uint8_t)byte();
      total += counts[i];
    }
    len -= 17;
    if (total > 256 || total > len) fail("bad JPEG Huffman table");
    for (int i = 0; i < total; i++) vals[i] = (uint8_t)byte();
    len -= total;
    int tc = index >> 4, th = index & 15;
    if (th > 3 || tc > 1) fail("bad JPEG Huffman table index");
    build_huffman(tc ? ac_[th] : dc_[th], counts, vals, total);
  }
}

void Decoder::read_sof(int marker) {
  if (have_sof_) fail("more than one SOF marker");
  u16();
  int precision = byte();
  height = u16();
  width = u16();
  int nc = byte();
  if (precision != 8)
    fail(std::to_string(precision) + "-bit JPEG precision is not supported");
  progressive_ = marker == 0xC2;
  if (height <= 0 || width <= 0) fail("JPEG with an empty image (or DNL)");
  if (nc != 1 && nc != 3)
    fail(std::to_string(nc) + "-component JPEG (" +
         (nc == 4 ? "CMYK/YCCK" : "unknown colour space") +
         ") is not supported");
  comps.assign(nc, Component());
  for (auto& c : comps) {
    c.id = byte();
    int hv = byte();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = byte();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      fail("bad JPEG sampling factors");
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
  mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
  for (auto& c : comps) {
    c.dw = (int)(((long)width * c.h + hmax_ - 1) / hmax_);
    c.dh = (int)(((long)height * c.v + vmax_ - 1) / vmax_);
    c.bw = (c.dw + 7) / 8;
    c.bh = (c.dh + 7) / 8;
    c.bw_alloc = std::max(c.bw, mcux_ * c.h);
    c.bh_alloc = std::max(c.bh, mcuy_ * c.v);
    c.coef.assign((size_t)c.bw_alloc * c.bh_alloc * 64, 0);
    for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
  }
  have_sof_ = true;
}

void Decoder::fill(int need) {
  while (nbits_ < need) {
    int c = 0;
    bool real = false;
    if (!marker_hit_) {
      if (pos_ < n_) {
        c = d_[pos_];
        if (c != 0xFF) {
          pos_++;
          real = true;
        } else {
          size_t q = pos_ + 1;
          while (q < n_ && d_[q] == 0xFF) q++;
          if (q < n_ && d_[q] == 0) {
            pos_ = q + 1;  // FF 00: an FF data byte
            c = 0xFF;
            real = true;
          } else {
            pos_ = q < n_ ? q - 1 : n_;  // stay on the marker's FF
            marker_hit_ = true;
          }
        }
      } else {
        marker_hit_ = true;
      }
    }
    if (!real) {
      c = 0;
      nfake_ += 8;
    }
    acc_ = (acc_ << 8) | (uint64_t)c;
    nbits_ += 8;
  }
}

int Decoder::get_bits(int n) {
  if (n == 0) return 0;
  fill(n);
  nbits_ -= n;
  int v = (int)((acc_ >> nbits_) & ((1u << n) - 1));
  if (nfake_ > nbits_) {
    insufficient_ = true;  // a bit past the end of the data was used
    nfake_ = nbits_;
  }
  return v;
}

int Decoder::peek8() {
  fill(8);
  return (int)((acc_ >> (nbits_ - 8)) & 0xFF);
}

int Decoder::decode(const Huffman& h) {
  if (!h.defined) fail("JPEG scan uses an undefined Huffman table");
  int look = h.look[peek8()];
  if (look >> 8) {
    get_bits(look >> 8);
    return look & 0xFF;
  }
  int l = 1;
  int code = get_bits(1);
  while (l <= 16 && code > h.maxcode[l]) {
    code = (code << 1) | get_bit();
    l++;
  }
  if (l > 16) return 0;  // corrupt data: libjpeg warns and takes symbol 0
  return h.vals[(code + h.valoffset[l]) & 0xFF];
}

void Decoder::process_restart() {
  // jdhuff.c process_restart + jdmarker.c read_restart_marker (any RSTn
  // is taken: a well-formed file has the expected one)
  reset_bits();
  if (!marker_hit_) {
    // skip to the next marker
    while (pos_ < n_) {
      if (d_[pos_] == 0xFF) {
        size_t q = pos_ + 1;
        while (q < n_ && d_[q] == 0xFF) q++;
        if (q < n_ && d_[q] != 0) {
          pos_ = q - 1;
          break;
        }
        pos_ = q;
      } else {
        pos_++;
      }
    }
  }
  marker_hit_ = false;
  bool at_rst = false;
  if (pos_ + 1 < n_ && d_[pos_] == 0xFF) {
    size_t q = pos_ + 1;
    while (q < n_ && d_[q] == 0xFF) q++;
    if (q < n_ && d_[q] >= 0xD0 && d_[q] <= 0xD7) {
      at_rst = true;
      pos_ = q + 1;
    }
  }
  for (auto& c : comps) c.last_dc = 0;
  eobrun_ = 0;
  if (at_rst)
    insufficient_ = false;
  else
    marker_hit_ = true;  // not a restart marker: the segment reads zeros
}

void Decoder::decode_block_baseline(Component& c, int16_t* blk) {
  int s = decode(dc_[c.dc_tbl]);
  if (s) s = extend(get_bits(s), s);
  s = (int)((unsigned)s + (unsigned)c.last_dc);
  c.last_dc = s;
  blk[0] = (int16_t)s;
  const Huffman& ac = ac_[c.ac_tbl];
  for (int k = 1; k < 64; k++) {
    int rs = decode(ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      int v = extend(get_bits(s), s);
      blk[kNatural[std::min(k, 79)]] = (int16_t)v;
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void Decoder::decode_dc_first(Component& c, int16_t* blk, int al) {
  int s = decode(dc_[c.dc_tbl]);
  if (s) s = extend(get_bits(s), s);
  s = (int)((unsigned)s + (unsigned)c.last_dc);
  c.last_dc = s;
  blk[0] = (int16_t)((unsigned)s << al);
}

void Decoder::decode_dc_refine(int16_t* blk, int al) {
  if (get_bit()) blk[0] = (int16_t)(blk[0] | (1 << al));
}

void Decoder::decode_ac_first(Component& c, int16_t* blk, int ss, int se,
                              int al) {
  if (eobrun_ > 0) {
    eobrun_--;
    return;
  }
  const Huffman& ac = ac_[c.ac_tbl];
  for (int k = ss; k <= se; k++) {
    int rs = decode(ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      int v = extend(get_bits(s), s);
      blk[kNatural[std::min(k, 79)]] = (int16_t)((unsigned)v << al);
    } else {
      if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        eobrun_--;
        break;
      }
    }
  }
}

void Decoder::decode_ac_refine(Component& c, int16_t* blk, int ss, int se,
                               int al) {
  const int p1 = 1 << al, m1 = -1 * (1 << al);
  const Huffman& ac = ac_[c.ac_tbl];
  int k = ss;
  if (eobrun_ == 0) {
    for (; k <= se; k++) {
      int rs = decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = get_bit() ? p1 : m1;
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        break;
      }
      do {
        int16_t* coef = blk + kNatural[std::min(k, 79)];
        if (*coef != 0) {
          if (get_bit()) {
            if ((*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1
                                                                : *coef + m1);
          }
        } else {
          if (--r < 0) break;
        }
        k++;
      } while (k <= se);
      if (s) blk[kNatural[std::min(k, 79)]] = (int16_t)s;
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se; k++) {
      int16_t* coef = blk + kNatural[std::min(k, 79)];
      if (*coef != 0) {
        if (get_bit()) {
          if ((*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1
                                                              : *coef + m1);
        }
      }
    }
    eobrun_--;
  }
}

void Decoder::read_sos() {
  if (!have_sof_) fail("JPEG scan before the SOF marker");
  u16();
  int ns = byte();
  if (ns < 1 || ns > 4) fail("bad JPEG scan component count");
  std::vector<Component*> sc;
  for (int i = 0; i < ns; i++) {
    int id = byte(), t = byte();
    Component* found = nullptr;
    for (auto& c : comps)
      if (c.id == id) found = &c;
    if (!found) fail("JPEG scan names an unknown component");
    found->dc_tbl = t >> 4;
    found->ac_tbl = t & 15;
    if (found->dc_tbl > 3 || found->ac_tbl > 3)
      fail("bad JPEG Huffman table index");
    sc.push_back(found);
  }
  int ss = byte(), se = byte(), a = byte();
  int ah = a >> 4, al = a & 15;
  if (progressive_) {
    // jdphuff.c start_pass_phuff_decoder's checks
    bool bad = (ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1)) ||
               (ah != 0 && al != ah - 1) || al > 13;
    if (bad) fail("bad progressive JPEG scan parameters");
    for (Component* c : sc)
      for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
  }
  for (Component* c : sc) {
    if (!c->latched) {
      if (!qt_set_[c->tq]) fail("JPEG component without a quantization table");
      memcpy(c->quant, qt_[c->tq], sizeof(c->quant));
      c->latched = true;
    }
    c->last_dc = 0;
  }
  reset_bits();
  marker_hit_ = false;
  insufficient_ = false;
  eobrun_ = 0;
  long n_mcu;
  int mcu_w;
  if (ns == 1) {
    mcu_w = sc[0]->bw;
    n_mcu = (long)sc[0]->bw * sc[0]->bh;
  } else {
    mcu_w = mcux_;
    n_mcu = (long)mcux_ * mcuy_;
  }
  int restarts_to_go = restart_interval_;
  for (long m = 0; m < n_mcu; m++) {
    if (restart_interval_) {
      if (restarts_to_go == 0) {
        process_restart();
        restarts_to_go = restart_interval_;
      }
    }
    if (!insufficient_) {
      int my = (int)(m / mcu_w), mx = (int)(m % mcu_w);
      for (Component* c : sc) {
        int bh = ns == 1 ? 1 : c->v, bwn = ns == 1 ? 1 : c->h;
        for (int by = 0; by < bh; by++) {
          for (int bx = 0; bx < bwn; bx++) {
            int row = ns == 1 ? my : my * c->v + by;
            int col = ns == 1 ? mx : mx * c->h + bx;
            int16_t* blk =
                c->coef.data() + ((size_t)row * c->bw_alloc + col) * 64;
            if (!progressive_) {
              decode_block_baseline(*c, blk);
            } else if (ss == 0) {
              if (ah == 0)
                decode_dc_first(*c, blk, al);
              else
                decode_dc_refine(blk, al);
            } else if (ah == 0) {
              decode_ac_first(*c, blk, ss, se, al);
            } else {
              decode_ac_refine(*c, blk, ss, se, al);
            }
          }
        }
      }
    }
    if (restart_interval_) restarts_to_go--;
  }
  // the reader continues at the next marker
  reset_bits();
  marker_hit_ = false;
}

void Decoder::run(bool header_only) {
  if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file");
  pos_ = 2;
  bool saw_scan = false;
  for (;;) {
    int m = next_marker();
    if (m < 0 || m == 0xD9) break;  // end of data or EOI
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      read_sof(m);
    } else if (m == 0xC3) {
      fail("lossless JPEG (SOF3) is not supported");
    } else if ((m >= 0xC5 && m <= 0xC7) || (m >= 0xCD && m <= 0xCF)) {
      fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
           ") is not supported");
    } else if ((m >= 0xC9 && m <= 0xCB) || m == 0xCC) {
      fail("arithmetic-coded JPEG is not supported");
    } else if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      u16();
      restart_interval_ = u16();
    } else if (m == 0xDA) {
      if (header_only) {
        if (!have_sof_) fail("JPEG scan before the SOF marker");
        return;
      }
      read_sos();
      saw_scan = true;
    } else if (m >= 0xE0 && m <= 0xEF) {
      read_app(m);
    } else if (m >= 0xD0 && m <= 0xD7) {
      // stray restart marker: no payload
    } else if (m == 0x01) {
      // TEM: no payload
    } else if (m == 0xD8) {
      fail("JPEG with a second SOI marker");
    } else {
      skip_segment();  // COM, DNL, DHP, EXP, JPGn, ...
    }
  }
  if (!have_sof_) fail("JPEG without an SOF marker");
  if (!header_only && !saw_scan) fail("JPEG without image data");
}

int Decoder::color_space() const {
  if (comps.size() == 1) return 1;
  // jdapimin.c default_decompress_parms (libjpeg-turbo)
  if (jfif_) return 2;
  if (adobe_ >= 0) return adobe_ == 0 ? 3 : 2;
  if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66) return 3;
  return 2;
}

// jidctint.c jpeg_idct_islow, the output clamped (the SIMD routes' pack
// with saturation; the C route's range-limit table agrees on every value
// a well-formed file produces)
#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172
#define CONST_BITS 13
#define PASS1_BITS 2
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

static inline uint8_t clamp_out(int64_t v) {
  v += 128;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                       int stride) {
  int ws[64];
  for (int col = 0; col < 8; col++) {
    const int16_t* ip = in + col;
    const uint16_t* qp = q + col;
    int* wp = ws + col;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = (int)((int64_t)ip[0] * qp[0] * (1 << PASS1_BITS));
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = (int)DESCALE(tmp10 + tmp3, sh);
    wp[56] = (int)DESCALE(tmp10 - tmp3, sh);
    wp[8] = (int)DESCALE(tmp11 + tmp2, sh);
    wp[48] = (int)DESCALE(tmp11 - tmp2, sh);
    wp[16] = (int)DESCALE(tmp12 + tmp1, sh);
    wp[40] = (int)DESCALE(tmp12 - tmp1, sh);
    wp[24] = (int)DESCALE(tmp13 + tmp0, sh);
    wp[32] = (int)DESCALE(tmp13 - tmp0, sh);
  }
  const int sh = CONST_BITS + PASS1_BITS + 3;
  for (int row = 0; row < 8; row++) {
    const int* wp = ws + 8 * row;
    uint8_t* op = out + (size_t)row * stride;
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = clamp_out(DESCALE(tmp10 + tmp3, sh));
    op[7] = clamp_out(DESCALE(tmp10 - tmp3, sh));
    op[1] = clamp_out(DESCALE(tmp11 + tmp2, sh));
    op[6] = clamp_out(DESCALE(tmp11 - tmp2, sh));
    op[2] = clamp_out(DESCALE(tmp12 + tmp1, sh));
    op[5] = clamp_out(DESCALE(tmp12 - tmp1, sh));
    op[3] = clamp_out(DESCALE(tmp13 + tmp0, sh));
    op[4] = clamp_out(DESCALE(tmp13 - tmp0, sh));
  }
}

void Decoder::idct_all() {
  for (auto& c : comps) {
    if (!c.latched) {
      // a component no scan covered: libjpeg latches its table at output
      if (!qt_set_[c.tq]) fail("JPEG component without a quantization table");
      memcpy(c.quant, qt_[c.tq], sizeof(c.quant));
      c.latched = true;
    }
    const int stride = c.bw * 8;
    c.plane.assign((size_t)c.bh * 8 * stride, 0);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(c.coef.data() + ((size_t)by * c.bw_alloc + bx) * 64,
                   c.quant, c.plane.data() + (size_t)by * 8 * stride + bx * 8,
                   stride);
  }
}

// jdsample.c: the component's plane to full resolution (width_out =
// dw * hexp, height_out = dh * vexp samples, rows of that width)
void Decoder::upsample(const Component& c, std::vector<uint8_t>& out) const {
  const int hexp = hmax_ / c.h, vexp = vmax_ / c.v;
  if (hmax_ % c.h || vmax_ % c.v)
    throw Error{"JPEG with fractional sampling ratios is not supported"};
  const int stride = c.bw * 8, dw = c.dw, dh = c.dh;
  const int ow = dw * hexp, oh = dh * vexp;
  out.assign((size_t)ow * oh, 0);
  const uint8_t* p = c.plane.data();
  auto row = [&](int y) {
    return p + (size_t)std::min(std::max(y, 0), dh - 1) * stride;
  };
  if (hexp == 1 && vexp == 1) {
    for (int y = 0; y < dh; y++) memcpy(&out[(size_t)y * ow], row(y), dw);
  } else if (hexp == 2 && vexp == 1 && dw > 2) {
    for (int y = 0; y < dh; y++) {
      const uint8_t* in = row(y);
      uint8_t* o = &out[(size_t)y * ow];
      int v = in[0];
      o[0] = (uint8_t)v;
      o[1] = (uint8_t)((v * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        v = in[x] * 3;
        o[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
        o[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
      }
      v = in[dw - 1];
      o[2 * dw - 2] = (uint8_t)((v * 3 + in[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = (uint8_t)v;
    }
  } else if (hexp == 1 && vexp == 2) {
    for (int y = 0; y < dh; y++) {
      const uint8_t* in0 = row(y);
      for (int v = 0; v < 2; v++) {
        const uint8_t* in1 = row(v == 0 ? y - 1 : y + 1);
        const int bias = v == 0 ? 1 : 2;
        uint8_t* o = &out[(size_t)(2 * y + v) * ow];
        for (int x = 0; x < dw; x++)
          o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      }
    }
  } else if (hexp == 2 && vexp == 2 && dw > 2) {
    for (int y = 0; y < dh; y++) {
      const uint8_t* in0 = row(y);
      for (int v = 0; v < 2; v++) {
        const uint8_t* in1 = row(v == 0 ? y - 1 : y + 1);
        uint8_t* o = &out[(size_t)(2 * y + v) * ow];
        int thiscol = in0[0] * 3 + in1[0];
        int nextcol = in0[1] * 3 + in1[1];
        o[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
        o[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int x = 1; x < dw - 1; x++) {
          nextcol = in0[x + 1] * 3 + in1[x + 1];
          o[2 * x] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
          o[2 * x + 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        o[2 * dw - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        o[2 * dw - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
      }
    }
  } else {
    // int_upsample / h2v1_upsample / h2v2_upsample: replication
    for (int y = 0; y < dh; y++) {
      const uint8_t* in = row(y);
      for (int v = 0; v < vexp; v++) {
        uint8_t* o = &out[(size_t)(y * vexp + v) * ow];
        for (int x = 0; x < dw; x++)
          for (int h = 0; h < hexp; h++) o[x * hexp + h] = in[x];
      }
    }
  }
}

void Decoder::output(int mode, uint8_t* out) {
  idct_all();
  const int cs = color_space();
  const size_t W = (size_t)width, H = (size_t)height;
  std::vector<uint8_t> planes[3];
  std::vector<int> widths(comps.size());
  const bool grey_out = mode == 0;
  const size_t needed = (grey_out && cs != 3) ? 1 : comps.size();
  for (size_t i = 0; i < needed; i++) {
    upsample(comps[i], planes[i]);
    widths[i] = comps[i].dw * (hmax_ / comps[i].h);
  }
  if (cs == 1) {
    for (size_t y = 0; y < H; y++) {
      const uint8_t* in = &planes[0][y * widths[0]];
      if (grey_out) {
        memcpy(out + y * W, in, W);
      } else {
        uint8_t* o = out + y * W * 3;
        for (size_t x = 0; x < W; x++)
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
      }
    }
    return;
  }
  if (cs == 2 && grey_out) {  // grayscale_convert: the Y plane
    for (size_t y = 0; y < H; y++)
      memcpy(out + y * W, &planes[0][y * widths[0]], W);
    return;
  }
  const int64_t ONE_HALF = (int64_t)1 << 15;
  auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
  if (cs == 3) {
    if (grey_out) {  // rgb_gray_convert
      const int64_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
      for (size_t y = 0; y < H; y++)
        for (size_t x = 0; x < W; x++) {
          const int64_t r = planes[0][y * widths[0] + x],
                        g = planes[1][y * widths[1] + x],
                        b = planes[2][y * widths[2] + x];
          out[y * W + x] =
              (uint8_t)((ry * r + gy * g + by * b + ONE_HALF) >> 16);
        }
      return;
    }
    for (size_t y = 0; y < H; y++)
      for (size_t x = 0; x < W; x++) {
        uint8_t* o = out + (y * W + x) * 3;
        o[2] = planes[0][y * widths[0] + x];
        o[1] = planes[1][y * widths[1] + x];
        o[0] = planes[2][y * widths[2] + x];
      }
    return;
  }
  // jdcolor.c build_ycc_rgb_table + ycc_rgb_convert
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; i++) {
    int64_t x = i - 128;
    cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> 16);
    cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> 16);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + ONE_HALF;
  }
  auto lim = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (size_t y = 0; y < H; y++) {
    const uint8_t* py = &planes[0][y * widths[0]];
    const uint8_t* pb = &planes[1][y * widths[1]];
    const uint8_t* pr = &planes[2][y * widths[2]];
    uint8_t* o = out + y * W * 3;
    for (size_t x = 0; x < W; x++) {
      int Y = py[x], cb = pb[x], cr = pr[x];
      o[3 * x + 2] = lim(Y + cr_r[cr]);
      o[3 * x + 1] = lim(Y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      o[3 * x + 0] = lim(Y + cb_b[cb]);
    }
  }
}

// jdcoefct.c smoothing_ok: a progressive file whose every component has
// its DC at least partly known and one of AC 1-9 not complete
bool Decoder::would_smooth() const {
  if (!progressive_) return false;
  bool useful = false;
  for (const auto& c : comps) {
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; k++)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

void set_error(char* err, int errlen, const std::string& m) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", m.c_str());
}

}  // namespace

extern "C" {

// (height, width, components) of the frame; 0 on success, 1 with a
// message in ``err``.
int jpeg_header(const uint8_t* data, long n, int* info, char* err,
                int errlen) {
  try {
    Decoder dec(data, n);
    dec.run(true);
    info[0] = dec.height;
    info[1] = dec.width;
    info[2] = (int)dec.comps.size();
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 1;
  }
}

// Decodes into ``out``: (H, W, 3) BGR for mode 1 (cv2.IMREAD_COLOR), (H, W)
// for mode 0 (cv2.IMREAD_GRAYSCALE).  0 on success, 1 with a message, 2
// when decoded without the block smoothing libjpeg would apply.
int jpeg_decode(const uint8_t* data, long n, int mode, uint8_t* out,
                char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.run(false);
    dec.output(mode, out);
    return dec.would_smooth() ? 2 : 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 1;
  }
}

}  // extern "C"
