// Ogg page reader written from RFC 3533, for the host audio decode of
// dali_tpu_torch: the packets of the first logical stream of a file.
//
// Each page's capture pattern, version and CRC-32 (polynomial 0x04C11DB7,
// over the page with its CRC field zeroed) are checked; a page that fails is
// skipped and the reader resynchronises on the next capture pattern, as
// FFmpeg's demuxer does. Lacing values join into packets, across pages when
// a page ends in a 255-byte segment and the next is marked continued. A page
// cut short by the end of the data is dropped, and with it a packet left
// open. Pages of other logical streams are skipped. After the first
// stream's last page, a page that begins a stream or continues the first
// (a chained file, whose streams FFmpeg decodes one after another) makes the
// read kUnsupported.

#include <cstring>

#include "audio_codecs.h"

namespace audio_codecs {
namespace {

struct Crc {
  uint32_t t[256];
  Crc() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t r = i << 24;
      for (int k = 0; k < 8; k++) r = (r & 0x80000000u) ? (r << 1) ^ 0x04C11DB7u : r << 1;
      t[i] = r;
    }
  }
};

uint32_t le32(const uint8_t* p) {
  return p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}

bool page_crc_ok(const uint8_t* d, size_t page_len) {
  static const Crc crc;
  uint32_t c = 0;
  for (size_t i = 0; i < page_len; i++) {
    const uint8_t b = (i >= 22 && i < 26) ? 0 : d[i];
    c = (c << 8) ^ crc.t[((c >> 24) ^ b) & 0xFF];
  }
  return c == le32(d + 22);
}

bool capture(const uint8_t* d) { return !std::memcmp(d, "OggS", 4) && d[4] == 0; }

// The length of the page whose header is at ``d`` (at least 27 bytes), or 0
// where its lacing or body runs past ``len``.
size_t page_extent(const uint8_t* d, size_t len) {
  const size_t nseg = d[26];
  if (27 + nseg > len) return 0;
  size_t n = 27 + nseg;
  for (size_t i = 0; i < nseg; i++) n += d[27 + i];
  return n <= len ? n : 0;
}

// After the first stream's last page: a page that begins a stream, or one
// more of the first stream's own, makes a chained file. Pages of streams
// multiplexed beside the first one do not.
bool chained(const uint8_t* d, size_t len, uint32_t serial) {
  for (size_t pos = 0; pos + 27 <= len;) {
    const size_t n = capture(d + pos) ? page_extent(d + pos, len - pos) : 1;
    if (n == 0) break;
    if (n == 1 || !page_crc_ok(d + pos, n)) {
      pos++;
      continue;
    }
    if ((d[pos + 5] & 2) || le32(d + pos + 14) == serial) return true;
    pos += n;
  }
  return false;
}

}  // namespace

int ogg_read(const uint8_t* d, size_t len, OggStream& out) {
  out.data.clear();
  out.packets.clear();
  bool have_serial = false;
  bool open = false;  // a packet continues onto the next page
  int page = 0;
  size_t open_start = 0;
  size_t pos = 0;
  while (pos + 27 <= len) {
    if (!capture(d + pos)) {
      pos++;
      continue;
    }
    const size_t page_len = page_extent(d + pos, len - pos);
    if (!page_len) break;  // cut short by the end of the data
    if (!page_crc_ok(d + pos, page_len)) {
      pos++;
      continue;
    }
    const size_t nseg = d[pos + 26];
    const uint8_t flags = d[pos + 5];
    int64_t granule = 0;
    for (int i = 7; i >= 0; i--) granule = (granule << 8) | d[pos + 6 + i];
    const uint32_t serial = le32(d + pos + 14);
    if (!have_serial) {
      out.serial = serial;
      have_serial = true;
    }
    if (serial != out.serial) {
      pos += page_len;
      continue;
    }
    if (!(flags & 1) && open) {  // a continued packet whose page is missing
      out.data.resize(open_start);
      open = false;
    }
    const uint8_t* lacing = d + pos + 27;
    size_t at = pos + 27 + nseg;
    size_t seg = 0;
    if ((flags & 1) && !open) {  // the end of a packet not seen: skipped
      while (seg < nseg && lacing[seg] == 255) at += lacing[seg++];
      if (seg < nseg) at += lacing[seg++];
    }
    size_t last_end = out.packets.size();
    for (; seg < nseg; seg++) {
      if (!open) {
        open_start = out.data.size();
        open = true;
      }
      out.data.insert(out.data.end(), d + at, d + at + lacing[seg]);
      at += lacing[seg];
      if (lacing[seg] < 255) {
        out.packets.push_back({open_start, out.data.size() - open_start, granule, page, flags,
                               false});
        open = false;
      }
    }
    if (out.packets.size() > last_end) out.packets.back().last_on_page = true;
    page++;
    pos += page_len;
    if (flags & 4) {  // end of stream: what follows may begin another
      if (open) out.data.resize(open_start);
      if (chained(d + pos, len - pos, out.serial)) return kUnsupported;
      return out.packets.empty() ? kMalformed : kOk;
    }
  }
  if (open) out.data.resize(open_start);
  return out.packets.empty() ? kMalformed : kOk;
}

}  // namespace audio_codecs
