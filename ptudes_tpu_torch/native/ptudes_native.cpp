// ptudes-tpu native runtime: pcap splitting + Ouster packet decoding.
//
// A copy of ptudes_tpu/native/ptudes_native.cpp for the PyTorch port. The
// compute path runs on the card; this library is the host-side IO runtime — the role ouster-sdk's C++
// PacketFormat/ScanBatcher play for the reference (SURVEY.md section 2b),
// rebuilt for batch throughput: one pass over a memory-mapped capture
// splits UDP payload offsets by size class, and packet decoding writes
// straight into caller-provided dense arrays (zero copies beyond the
// unavoidable decode).
//
// C ABI only (consumed via ctypes); no external dependencies.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- pcap

// Scan a classic pcap buffer, REASSEMBLE IPv4 fragments, and write every
// UDP payload contiguously into `arena`. Real Ouster lidar packets
// (12-25 KB) exceed Ethernet MTU and arrive fragmented; the reference's
// ouster-sdk pcap layer reassembles them, so must we.
//
// Two-pass protocol (ctypes-friendly, zero allocations inside):
//   pass 1: arena_cap = 0, max_out = 0 -> returns datagram count and sets
//           *arena_used to the total payload bytes needed;
//   pass 2: with arena/offsets/lengths/ts_ns sized accordingly -> fills.
// Returns -1 on malformed/unsupported (big-endian) captures.
//
// Reassembly model: up to RS_SLOTS concurrent (src, dst, ip_id) datagrams,
// in-order or out-of-order fragments, no overlap handling (never produced
// by sensors); incomplete datagrams are dropped.
namespace {
constexpr int RS_SLOTS = 8;
constexpr int64_t RS_MAX = 65536;
struct Reasm {
    uint64_t key = 0;       // src^dst^(id<<32), 0 = free
    int64_t got = 0;        // bytes received so far
    int64_t total = -1;     // total IP payload bytes (known at last frag)
    int64_t ts_ns = 0;
    uint8_t buf[RS_MAX];
};
}  // namespace

int64_t pcap_split_udp(const uint8_t* data, int64_t len,
                       uint8_t* arena, int64_t arena_cap,
                       int64_t* offsets, int64_t* lengths, int64_t* ts_ns,
                       int64_t max_out, int64_t* arena_used) {
    if (len < 24) return -1;
    uint32_t magic;
    std::memcpy(&magic, data, 4);
    double frac_scale;
    if (magic == 0xa1b2c3d4u) frac_scale = 1000.0;        // usec -> ns
    else if (magic == 0xa1b23c4du) frac_scale = 1.0;      // nsec
    else return -1;  // big-endian captures: fall back to python path

    static thread_local Reasm slots[RS_SLOTS];
    for (auto& s : slots) { s.key = 0; s.got = 0; s.total = -1; }

    int64_t pos = 24;
    int64_t n = 0;
    int64_t used = 0;

    auto emit = [&](const uint8_t* payload, int64_t plen, int64_t t) {
        if (plen <= 0) return;
        if (n < max_out && used + plen <= arena_cap) {
            std::memcpy(arena + used, payload, plen);
            offsets[n] = used;
            lengths[n] = plen;
            ts_ns[n] = t;
        }
        used += plen;
        n++;
    };

    while (pos + 16 <= len) {
        uint32_t sec, frac, incl;
        std::memcpy(&sec, data + pos, 4);
        std::memcpy(&frac, data + pos + 4, 4);
        std::memcpy(&incl, data + pos + 8, 4);
        pos += 16;
        if (pos + (int64_t)incl > len) break;
        const uint8_t* p = data + pos;
        int64_t rec_end = pos + incl;
        pos = rec_end;
        if (incl < 14 + 20 + 8) continue;
        uint16_t ethertype = (uint16_t)((p[12] << 8) | p[13]);
        const uint8_t* ip = p + 14;
        if (ethertype == 0x8100) {  // VLAN tag
            ethertype = (uint16_t)((p[16] << 8) | p[17]);
            ip = p + 18;
        }
        if (ethertype != 0x0800) continue;           // IPv4 only
        int ihl = (ip[0] & 0x0F) * 4;
        if (ip[9] != 17) continue;                   // UDP
        int64_t t = (int64_t)sec * 1000000000LL + (int64_t)(frac * frac_scale);
        int64_t ip_total = (ip[2] << 8) | ip[3];
        if (ip_total > rec_end - ((ip - data))) ip_total = rec_end - (ip - data);
        const uint8_t* ippay = ip + ihl;
        int64_t ippay_len = ip_total - ihl;
        if (ippay + ippay_len > data + rec_end)
            ippay_len = (data + rec_end) - ippay;
        if (ippay_len <= 0) continue;

        uint16_t fragfield = (uint16_t)((ip[6] << 8) | ip[7]);
        bool mf = fragfield & 0x2000;
        int64_t frag_off = (int64_t)(fragfield & 0x1FFF) * 8;

        if (!mf && frag_off == 0) {                  // unfragmented
            int64_t udp_len = (ippay[4] << 8) | ippay[5];
            int64_t plen = udp_len - 8;
            if (plen > ippay_len - 8) plen = ippay_len - 8;
            emit(ippay + 8, plen, t);
            continue;
        }

        // fragment: find / claim a reassembly slot
        uint32_t src, dst;
        std::memcpy(&src, ip + 12, 4);
        std::memcpy(&dst, ip + 16, 4);
        uint64_t key = ((uint64_t)(uint16_t)((ip[4] << 8) | ip[5]) << 32)
                       ^ src ^ ((uint64_t)dst << 13) ^ 1;
        Reasm* slot = nullptr;
        for (auto& s : slots) if (s.key == key) { slot = &s; break; }
        if (!slot) {
            for (auto& s : slots) if (s.key == 0) { slot = &s; break; }
            if (!slot) slot = &slots[0];             // evict oldest-ish
            slot->key = key; slot->got = 0; slot->total = -1;
        }
        if (frag_off + ippay_len > RS_MAX) { slot->key = 0; continue; }
        std::memcpy(slot->buf + frag_off, ippay, ippay_len);
        slot->got += ippay_len;
        slot->ts_ns = t;                             // last fragment's ts
        if (!mf) slot->total = frag_off + ippay_len;
        if (slot->total >= 0 && slot->got >= slot->total) {
            int64_t udp_len = (slot->buf[4] << 8) | slot->buf[5];
            int64_t plen = udp_len - 8;
            if (plen > slot->total - 8) plen = slot->total - 8;
            emit(slot->buf + 8, plen, slot->ts_ns);
            slot->key = 0;
        }
    }
    if (arena_used) *arena_used = used;
    return n;
}

// ------------------------------------------------------- lidar decoding

// LEGACY profile: n_pkts packets, each columns_per_packet blocks of
// (16 B header + h*12 B pixels + 4 B status). Outputs are per-column
// flattened [n_pkts*cpp] and [n_pkts*cpp, h].
void parse_legacy(const uint8_t* pkts, int64_t n_pkts, int64_t pkt_stride,
                  int32_t h, int32_t cpp,
                  uint64_t* ts, uint16_t* mid, uint16_t* fid,
                  uint8_t* status, uint32_t* range_mm,
                  uint16_t* reflectivity, uint16_t* signal, uint16_t* nir) {
    const int64_t block = 16 + (int64_t)h * 12 + 4;
    for (int64_t ip = 0; ip < n_pkts; ip++) {
        const uint8_t* pkt = pkts + ip * pkt_stride;
        for (int32_t c = 0; c < cpp; c++) {
            const uint8_t* col = pkt + c * block;
            int64_t oc = ip * cpp + c;
            std::memcpy(&ts[oc], col, 8);
            std::memcpy(&mid[oc], col + 8, 2);
            std::memcpy(&fid[oc], col + 10, 2);
            uint32_t st;
            std::memcpy(&st, col + block - 4, 4);
            status[oc] = (st == 0xFFFFFFFFu) ? 1 : 0;
            const uint8_t* px = col + 16;
            uint32_t* r = range_mm + oc * h;
            uint16_t* rf = reflectivity + oc * h;
            uint16_t* sg = signal + oc * h;
            uint16_t* nr = nir + oc * h;
            for (int32_t i = 0; i < h; i++) {
                uint32_t w0;
                std::memcpy(&w0, px + (int64_t)i * 12, 4);
                r[i] = w0 & 0x000FFFFFu;
                std::memcpy(&rf[i], px + (int64_t)i * 12 + 4, 2);
                std::memcpy(&sg[i], px + (int64_t)i * 12 + 6, 2);
                std::memcpy(&nr[i], px + (int64_t)i * 12 + 8, 2);
            }
        }
    }
}

// RNG19_RFL8_SIG16_NIR16 single-return eUDP profile:
// 32 B packet header + cpp * (12 B column header + h*12 B pixels) + 32 B.
void parse_rng19(const uint8_t* pkts, int64_t n_pkts, int64_t pkt_stride,
                 int32_t h, int32_t cpp,
                 uint64_t* ts, uint16_t* mid, uint16_t* fid,
                 uint8_t* status, uint32_t* range_mm,
                 uint16_t* reflectivity, uint16_t* signal, uint16_t* nir) {
    const int64_t col_bytes = 12 + (int64_t)h * 12;
    for (int64_t ip = 0; ip < n_pkts; ip++) {
        const uint8_t* pkt = pkts + ip * pkt_stride;
        uint16_t frame_id;
        std::memcpy(&frame_id, pkt + 2, 2);
        const uint8_t* body = pkt + 32;
        for (int32_t c = 0; c < cpp; c++) {
            const uint8_t* col = body + c * col_bytes;
            int64_t oc = ip * cpp + c;
            std::memcpy(&ts[oc], col, 8);
            std::memcpy(&mid[oc], col + 8, 2);
            uint16_t st;
            std::memcpy(&st, col + 10, 2);
            status[oc] = st & 0x1;
            fid[oc] = frame_id;
            const uint8_t* px = col + 12;
            uint32_t* r = range_mm + oc * h;
            uint16_t* rf = reflectivity + oc * h;
            uint16_t* sg = signal + oc * h;
            uint16_t* nr = nir + oc * h;
            for (int32_t i = 0; i < h; i++) {
                uint32_t w0;
                std::memcpy(&w0, px + (int64_t)i * 12, 4);
                r[i] = w0 & 0x0007FFFFu;
                rf[i] = px[(int64_t)i * 12 + 4];
                std::memcpy(&sg[i], px + (int64_t)i * 12 + 6, 2);
                std::memcpy(&nr[i], px + (int64_t)i * 12 + 8, 2);
            }
        }
    }
}

// Shared eUDP column walker: 32 B packet header (frame id u16 @2) +
// cpp * (12 B column header + h*pixel_bytes), pixel decode per profile.
// (templates can't live inside the extern "C" block)
}  // extern "C"

namespace {
template <typename PixelFn>
void parse_eudp(const uint8_t* pkts, int64_t n_pkts, int64_t pkt_stride,
                int32_t h, int32_t cpp, int32_t pixel_bytes,
                uint64_t* ts, uint16_t* mid, uint16_t* fid,
                uint8_t* status, PixelFn&& pixel) {
    const int64_t col_bytes = 12 + (int64_t)h * pixel_bytes;
    for (int64_t ip = 0; ip < n_pkts; ip++) {
        const uint8_t* pkt = pkts + ip * pkt_stride;
        uint16_t frame_id;
        std::memcpy(&frame_id, pkt + 2, 2);
        const uint8_t* body = pkt + 32;
        for (int32_t c = 0; c < cpp; c++) {
            const uint8_t* col = body + c * col_bytes;
            int64_t oc = ip * cpp + c;
            std::memcpy(&ts[oc], col, 8);
            std::memcpy(&mid[oc], col + 8, 2);
            uint16_t st;
            std::memcpy(&st, col + 10, 2);
            status[oc] = st & 0x1;
            fid[oc] = frame_id;
            const uint8_t* px = col + 12;
            for (int32_t i = 0; i < h; i++)
                pixel(oc, i, px + (int64_t)i * pixel_bytes);
        }
    }
}
}  // namespace

extern "C" {

// RNG15_RFL8_NIR8 low-bandwidth eUDP: 4 B/px — u16 range (x8 mm, scaled
// to mm here like the numpy path), u8 refl, u8 nir; no signal field.
void parse_rng15(const uint8_t* pkts, int64_t n_pkts, int64_t pkt_stride,
                 int32_t h, int32_t cpp,
                 uint64_t* ts, uint16_t* mid, uint16_t* fid,
                 uint8_t* status, uint32_t* range_mm,
                 uint16_t* reflectivity, uint16_t* signal, uint16_t* nir) {
    parse_eudp(pkts, n_pkts, pkt_stride, h, cpp, 4, ts, mid, fid, status,
               [&](int64_t oc, int32_t i, const uint8_t* p) {
        uint16_t raw;
        std::memcpy(&raw, p, 2);
        range_mm[oc * h + i] = (uint32_t)raw * 8u;
        reflectivity[oc * h + i] = p[2];
        signal[oc * h + i] = 0;
        nir[oc * h + i] = p[3];
    });
}

// RNG19_RFL8_SIG16_NIR16_DUAL: 16 B/px — [u32 range1(19b) | refl1 @3]
// [u32 range2(19b) | refl2 @7] [u16 sig1 @8] [u16 sig2 @10] [u16 nir @12].
void parse_dual(const uint8_t* pkts, int64_t n_pkts, int64_t pkt_stride,
                int32_t h, int32_t cpp,
                uint64_t* ts, uint16_t* mid, uint16_t* fid,
                uint8_t* status, uint32_t* range_mm,
                uint16_t* reflectivity, uint16_t* signal, uint16_t* nir,
                uint32_t* range2_mm, uint16_t* reflectivity2,
                uint16_t* signal2) {
    parse_eudp(pkts, n_pkts, pkt_stride, h, cpp, 16, ts, mid, fid, status,
               [&](int64_t oc, int32_t i, const uint8_t* p) {
        int64_t o = oc * h + i;
        uint32_t w0, w1;
        std::memcpy(&w0, p, 4);
        std::memcpy(&w1, p + 4, 4);
        range_mm[o] = w0 & 0x0007FFFFu;
        reflectivity[o] = p[3];
        range2_mm[o] = w1 & 0x0007FFFFu;
        reflectivity2[o] = p[7];
        std::memcpy(&signal[o], p + 8, 2);
        std::memcpy(&signal2[o], p + 10, 2);
        std::memcpy(&nir[o], p + 12, 2);
    });
}

// FUSA_RNG15_RFL8_NIR8_DUAL: 8 B/px — two returns of
// [u16 range(15b, x8 mm) | u8 refl | u8 nir-or-refl2]; no signal fields.
void parse_fusa(const uint8_t* pkts, int64_t n_pkts, int64_t pkt_stride,
                int32_t h, int32_t cpp,
                uint64_t* ts, uint16_t* mid, uint16_t* fid,
                uint8_t* status, uint32_t* range_mm,
                uint16_t* reflectivity, uint16_t* signal, uint16_t* nir,
                uint32_t* range2_mm, uint16_t* reflectivity2,
                uint16_t* signal2) {
    parse_eudp(pkts, n_pkts, pkt_stride, h, cpp, 8, ts, mid, fid, status,
               [&](int64_t oc, int32_t i, const uint8_t* p) {
        int64_t o = oc * h + i;
        uint16_t raw1, raw2;
        std::memcpy(&raw1, p, 2);
        std::memcpy(&raw2, p + 4, 2);
        range_mm[o] = (uint32_t)(raw1 & 0x7FFF) * 8u;
        reflectivity[o] = p[2];
        nir[o] = p[3];
        range2_mm[o] = (uint32_t)(raw2 & 0x7FFF) * 8u;
        reflectivity2[o] = p[6];
        signal[o] = 0;
        signal2[o] = 0;
    });
}

// IMU packets: 48 B — 3 x u64 ts + 3 x f32 accel(g) + 3 x f32 gyro(deg/s).
// accel/gyro timestamps decoded too (offsets 8/16) so the native and numpy
// paths return identical fields.
void parse_imu(const uint8_t* pkts, int64_t n_pkts, int64_t pkt_stride,
               uint64_t* sys_ts, uint64_t* accel_ts, uint64_t* gyro_ts,
               float* accel_g, float* avel_deg) {
    for (int64_t i = 0; i < n_pkts; i++) {
        const uint8_t* p = pkts + i * pkt_stride;
        std::memcpy(&sys_ts[i], p, 8);
        std::memcpy(&accel_ts[i], p + 8, 8);
        std::memcpy(&gyro_ts[i], p + 16, 8);
        std::memcpy(&accel_g[i * 3], p + 24, 12);
        std::memcpy(&avel_deg[i * 3], p + 36, 12);
    }
}


// LZ4 block decompression (frame layer stays in Python — io/lz4f.py).
// dst is pre-filled with hist_len bytes of window history (block-linked
// frames); output starts at hist_len and matches may reach into the
// history. Returns the PRODUCED length (excluding history), -1 on
// malformed input, -2 when dst_cap is too small (caller grows + retries).
int64_t lz4_block_decompress(const uint8_t* src, int64_t n,
                             uint8_t* dst, int64_t dst_cap,
                             int64_t hist_len) {
    int64_t i = 0, o = hist_len;
    while (i < n) {
        uint8_t token = src[i++];
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (i >= n) return -1;
                b = src[i++];
                lit += b;
            } while (b == 255);
        }
        if (lit) {
            if (i + lit > n) return -1;
            if (o + lit > dst_cap) return -2;
            std::memcpy(dst + o, src + i, (size_t)lit);
            i += lit; o += lit;
        }
        if (i >= n) break;  // last sequence: literals only
        if (i + 2 > n) return -1;
        int64_t offset = src[i] | ((int64_t)src[i + 1] << 8);
        i += 2;
        if (offset == 0 || offset > o) return -1;  // o includes history
        int64_t mlen = token & 0xF;
        if (mlen == 15) {
            uint8_t b;
            do {
                if (i >= n) return -1;
                b = src[i++];
                mlen += b;
            } while (b == 255);
        }
        mlen += 4;
        if (o + mlen > dst_cap) return -2;
        const uint8_t* from = dst + o - offset;
        if (offset >= mlen) {
            std::memcpy(dst + o, from, (size_t)mlen);
        } else {
            for (int64_t k = 0; k < mlen; k++) dst[o + k] = from[k];
        }
        o += mlen;
    }
    return o - hist_len;
}

}  // extern "C"
