// JPEG 2000 Part-1 codestream decoder (ISO/IEC 15444-1), the port's own,
// with OpenJPEG 2.5's arithmetic where the standard leaves room: the 9/7
// lifting in float32 with its constants and order of operations, the ICT
// in float32, the DC level shift with lrintf and the clamp to the
// component's range. Built by native.py without FMA contraction.
//
// Two entry points, both on a bare codestream (SOC ... EOC):
//   dg_j2k_info   -> the SIZ fields, from the main header alone;
//   dg_j2k_decode -> every component as int32 [ncomp][h][w] (image origin
//                    0 and no subsampling; the caller checks), the tiles,
//                    or a single tile's code-blocks and components, spread
//                    over up to eight threads.
// Each returns 0, 1 for a stream that does not decode (with a message) or
// 2 for a feature that is not read (with its name). Where a stream is
// malformed, the decode fails or goes on as OpenJPEG's does.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <tuple>
#include <vector>

namespace {

struct Fail {
    int code;
    std::string msg;
};

[[noreturn]] void bad(const std::string& m) { throw Fail{1, m}; }
[[noreturn]] void refuse(const std::string& m) { throw Fail{2, m}; }

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceil_pow2(int64_t a, int s) { return (a + (int64_t(1) << s) - 1) >> s; }
inline int64_t floor_pow2(int64_t a, int s) { return a >> s; }

// ---------------------------------------------------------------- markers

struct Reader {
    const uint8_t* p;
    int64_t n, pos = 0;
    Reader(const uint8_t* d, int64_t len) : p(d), n(len) {}
    void need(int64_t k) const {
        if (pos + k > n) bad("codestream ends inside a marker segment");
    }
    uint32_t u8() { need(1); return p[pos++]; }
    uint32_t u16() { need(2); uint32_t v = (p[pos] << 8) | p[pos + 1]; pos += 2; return v; }
    uint32_t u32() {
        need(4);
        uint32_t v = (uint32_t(p[pos]) << 24) | (p[pos + 1] << 16) | (p[pos + 2] << 8) | p[pos + 3];
        pos += 4;
        return v;
    }
};

struct Comp {
    int prec = 0, sgnd = 0, dx = 1, dy = 1;
};

struct Quant {
    int style = 0, guard = 2;
    std::vector<int> expn, mant;       // per band index (0 = LL, 3 (r-1) + o)
};

struct Coding {                        // COD/COC for one component
    int levels = 0, cbw = 6, cbh = 6, style = 0, wavelet = 1;
    std::vector<int> ppx, ppy;         // per resolution
};

struct Poc {                           // one progression volume of a POC marker
    int rs, cs, lye, re, ce, order;
};

// Packed packet headers: the segments of PPM (main header) or PPT (a
// tile's headers) by their index Z, each read once.
struct Packed {
    std::vector<std::vector<uint8_t>> parts;
    void add(Reader& r, int64_t end, const char* name) {
        if (end - r.pos < 2) bad(std::string(name) + " marker too short");
        uint32_t z = r.u8();
        if (parts.size() <= z) parts.resize(z + 1);
        if (!parts[z].empty()) bad(std::string(name) + " index read twice");
        parts[z].assign(r.p + r.pos, r.p + end);
    }
};

struct TileCoding {                    // COD's progression fields and per-component state
    int order = 0, layers = 1, mct = 0, sop = 0, eph = 0;
    std::vector<Poc> pocs;
    std::vector<Coding> coding;
    std::vector<Quant> quant;
    std::vector<int> roishift;         // RGN's maxshift per component
    std::vector<int> coc_set, qcc_set; // 1 when a COC/QCC of this tile's header set it
    Packed ppt;
};

struct Header {
    int rsiz = 0;
    int64_t xsiz = 0, ysiz = 0, x0 = 0, y0 = 0, xt = 0, yt = 0, xt0 = 0, yt0 = 0;
    std::vector<Comp> comps;
    TileCoding main;
    int have_cod = 0, have_qcd = 0;
    int ntx = 0, nty = 0;
    Packed ppm;
    std::vector<uint8_t> ppm_headers;  // the PPM data without its Nppm fields
};

void read_coding_style(Reader& r, int64_t end, Coding& c, int scod) {
    c.levels = r.u8();
    c.cbw = r.u8() + 2;
    c.cbh = r.u8() + 2;
    c.style = r.u8();
    c.wavelet = r.u8();
    if (c.levels > 32) bad("more than 32 decomposition levels");
    if (c.cbw > 10 || c.cbh > 10 || c.cbw + c.cbh > 12) bad("code-block size out of range");
    c.ppx.assign(c.levels + 1, 15);
    c.ppy.assign(c.levels + 1, 15);
    if (scod & 1) {
        for (int i = 0; i <= c.levels; ++i) {
            if (r.pos >= end) bad("COD/COC lacks precinct sizes");
            uint32_t v = r.u8();
            c.ppx[i] = v & 15;
            c.ppy[i] = v >> 4;
            if (i > 0 && (c.ppx[i] == 0 || c.ppy[i] == 0)) bad("precinct size 1 above resolution 0");
        }
    }
}

void read_quant(Reader& r, int64_t end, Quant& q) {
    uint32_t s = r.u8();
    q.style = s & 31;
    q.guard = s >> 5;
    q.expn.clear();
    q.mant.clear();
    if (q.style == 0) {
        while (r.pos < end) {
            q.expn.push_back(r.u8() >> 3);
            q.mant.push_back(0);
        }
    } else if (q.style == 1 || q.style == 2) {
        do {
            uint32_t v = r.u16();
            q.expn.push_back(v >> 11);
            q.mant.push_back(v & 0x7ff);
        } while (q.style == 2 && r.pos + 2 <= end);
    } else {
        bad("quantization style " + std::to_string(q.style));
    }
    if (q.expn.empty()) bad("quantization marker without step sizes");
}

// Code-block style flags (Table A.19); all six of Part 1 are decoded.
enum {
    LAZY = 0x01, RESET = 0x02, TERMALL = 0x04, VSC = 0x08, PTERM = 0x10, SEGSYM = 0x20,
    HT = 0x40,
};

void check_cblk_style(int st) {
    if (st & HT) refuse("HTJ2K (Part 15) high-throughput code-blocks");
    if (st & ~0x7f) bad("code-block style " + std::to_string(st));
}

void read_marker(Header& h, TileCoding& t, Reader& r, uint32_t m, int64_t end, bool in_tile) {
    int nc = int(h.comps.size());
    switch (m) {
    case 0xFF52: {  // COD
        int scod = r.u8();
        t.order = r.u8();
        t.layers = r.u16();
        t.mct = r.u8();
        if (t.order > 4) bad("progression order " + std::to_string(t.order));
        if (t.layers == 0) bad("zero quality layers");
        if (scod & ~7) bad("COD style " + std::to_string(scod));
        t.sop = (scod >> 1) & 1;
        t.eph = (scod >> 2) & 1;
        Coding c;
        read_coding_style(r, end, c, scod);
        for (int i = 0; i < nc; ++i)
            if (!t.coc_set[i]) t.coding[i] = c;
        if (!in_tile) h.have_cod = 1;
        break;
    }
    case 0xFF53: {  // COC
        int ci = nc < 257 ? r.u8() : r.u16();
        if (ci >= nc) bad("COC of a component that does not exist");
        int scoc = r.u8();
        Coding c;
        read_coding_style(r, end, c, scoc);
        t.coding[ci] = c;
        t.coc_set[ci] = 1;
        break;
    }
    case 0xFF5C: {  // QCD
        Quant q;
        read_quant(r, end, q);
        for (int i = 0; i < nc; ++i)
            if (!t.qcc_set[i]) t.quant[i] = q;
        if (!in_tile) h.have_qcd = 1;
        break;
    }
    case 0xFF5D: {  // QCC
        int ci = nc < 257 ? r.u8() : r.u16();
        if (ci >= nc) bad("QCC of a component that does not exist");
        Quant q;
        read_quant(r, end, q);
        t.quant[ci] = q;
        t.qcc_set[ci] = 1;
        break;
    }
    case 0xFF5E: {  // RGN: OpenJPEG reads its maxshift whatever Srgn says
        int room = nc <= 256 ? 1 : 2;
        if (end - r.pos != 2 + room) bad("RGN length");
        int ci = room == 1 ? r.u8() : r.u16();
        r.u8();
        if (ci >= nc) bad("RGN of a component that does not exist");
        t.roishift[ci] = r.u8();
        break;
    }
    case 0xFF5F: {  // POC: volumes appended to those of the main header
        int wide = nc >= 257 ? 2 : 1;
        int entry = 5 + 2 * wide;
        if ((end - r.pos) % entry || end == r.pos) bad("POC length is not a whole number of entries");
        while (r.pos < end) {
            Poc v;
            v.rs = r.u8();
            v.cs = wide == 2 ? r.u16() : r.u8();
            v.lye = r.u16();
            v.re = r.u8();
            v.ce = wide == 2 ? r.u16() : r.u8();
            if (v.ce == 0) v.ce = 256;
            v.order = r.u8();
            if (v.order > 4) bad("POC progression order " + std::to_string(v.order));
            t.pocs.push_back(v);
        }
        break;
    }
    case 0xFF60: h.ppm.add(r, end, "PPM"); break;
    case 0xFF61:
        if (!h.ppm.parts.empty()) bad("PPT marker after a PPM marker");
        t.ppt.add(r, end, "PPT");
        break;
    case 0xFF50: refuse("HTJ2K (Part 15) capabilities (CAP marker)");
    case 0xFF59: refuse("JPEG 2000 Part 2 (CPF marker)");
    case 0xFF74: case 0xFF75: case 0xFF77: case 0xFF78:
        refuse("JPEG 2000 Part 2 multi-component transform");
    default:
        break;  // COM, TLM, PLM, PLT, CRG and unknown segments carry nothing decoded
    }
    r.pos = end;
}

// OpenJPEG's opj_j2k_merge_ppm: the PPM segments in Zppm order as one
// stream of packet headers, each Nppm field dropped (a field's bytes may run
// on into the next segment); its tile-part boundaries are not kept.
void merge_ppm(Header& h) {
    if (h.ppm.parts.empty()) return;
    uint64_t left = 0;
    std::vector<uint8_t>& out = h.ppm_headers;
    for (const auto& seg : h.ppm.parts) {
        size_t at = 0, n = seg.size();
        if (n == 0) continue;
        size_t take = size_t(std::min<uint64_t>(left, n));
        out.insert(out.end(), seg.begin(), seg.begin() + take);
        at = take;
        left -= take;
        while (at < n) {
            if (n - at < 4) bad("not enough bytes to read Nppm");
            uint64_t nppm = (uint64_t(seg[at]) << 24) | (seg[at + 1] << 16) | (seg[at + 2] << 8)
                            | seg[at + 3];
            at += 4;
            take = size_t(std::min<uint64_t>(nppm, n - at));
            out.insert(out.end(), seg.begin() + at, seg.begin() + at + take);
            at += take;
            left = nppm - take;
        }
    }
    if (left) bad("corrupted PPM markers");
    if (out.empty()) bad("PPM markers without packet headers");   // OpenJPEG's malloc(0) fails
}

// Where OpenJPEG 2.5 takes each marker it knows: the main header (1), a
// tile-part header (2), nowhere (0); -1 for a marker it does not know.
enum { IN_MAIN = 1, IN_TILE = 2 };
int marker_places(uint32_t m) {
    switch (m) {
    case 0xFF90: return IN_MAIN;                                        // SOT ends it
    case 0xFF52: case 0xFF53: case 0xFF5E: case 0xFF5C: case 0xFF5D: case 0xFF5F:
    case 0xFF64: case 0xFF74: case 0xFF75: case 0xFF77: return IN_MAIN | IN_TILE;
    case 0xFF55: case 0xFF57: case 0xFF60: case 0xFF63: case 0xFF78: case 0xFF50:
    case 0xFF59: return IN_MAIN;
    case 0xFF58: case 0xFF61: return IN_TILE;
    case 0xFF51: case 0xFF91: return 0;
    default: return -1;
    }
}

// After a marker OpenJPEG does not know: its next known marker, sought two
// bytes at a time (the unknown segment's length is not read).
uint32_t skip_unknown(Reader& r, int place) {
    for (;;) {
        if (r.pos + 2 > r.n) bad("codestream ends after an unknown marker");
        uint32_t w = r.u16();
        if (w < 0xFF00) continue;
        int at = marker_places(w);
        if (at < 0) continue;
        if (!(at & place)) bad("a marker where it may not stand");
        return w;
    }
}

// The marker at the reader, or the known one after an unknown one.
uint32_t next_marker(Reader& r, int place, uint32_t stop) {
    uint32_t m = r.u16();
    if (m < 0xFF00) bad("expected a marker");
    if (m == stop) return m;
    int at = marker_places(m);
    if (at < 0) m = skip_unknown(r, place);
    else if (!(at & place)) bad("a marker where it may not stand");
    return m;
}

Header parse_main(Reader& r) {
    Header h;
    if (r.n < 4 || r.u16() != 0xFF4F) bad("no SOC marker");
    if (r.u16() != 0xFF51) bad("SIZ does not follow SOC");
    int64_t len = r.u16();
    int64_t end = r.pos + len - 2;
    if (len < 41) bad("SIZ too short");
    r.need(len - 2);
    h.rsiz = r.u16();
    h.xsiz = r.u32(); h.ysiz = r.u32(); h.x0 = r.u32(); h.y0 = r.u32();
    h.xt = r.u32(); h.yt = r.u32(); h.xt0 = r.u32(); h.yt0 = r.u32();
    int nc = r.u16();
    if (nc == 0 || nc > 16384 || len != 38 + 3 * nc) bad("SIZ component count does not match its length");
    if (h.x0 >= h.xsiz || h.y0 >= h.ysiz) bad("empty image area");
    if (h.xt == 0 || h.yt == 0) bad("zero tile size");
    if (h.xt0 > h.x0 || h.yt0 > h.y0 || h.xt0 + h.xt <= h.x0 || h.yt0 + h.yt <= h.y0)
        bad("tile grid does not cover the image origin");
    h.comps.resize(nc);
    for (auto& c : h.comps) {
        uint32_t s = r.u8();
        c.prec = (s & 0x7f) + 1;
        c.sgnd = s >> 7;
        c.dx = r.u8();
        c.dy = r.u8();
        if (c.dx == 0 || c.dy == 0) bad("zero component subsampling");
        if (c.prec > 38) bad("component precision above 38 bits");
    }
    r.pos = end;
    if (h.rsiz & 0x4000) refuse("HTJ2K (Part 15) codestream");
    if (h.rsiz & 0x8000) refuse("JPEG 2000 Part 2 (JPX) codestream extensions");
    h.ntx = int(ceil_div(h.xsiz - h.xt0, h.xt));
    h.nty = int(ceil_div(h.ysiz - h.yt0, h.yt));
    if (int64_t(h.ntx) * h.nty > 65535) bad("more than 65535 tiles");
    h.main.coding.assign(nc, Coding());
    h.main.quant.assign(nc, Quant());
    h.main.coc_set.assign(nc, 0);
    h.main.qcc_set.assign(nc, 0);
    h.main.roishift.assign(nc, 0);
    for (;;) {
        uint32_t m = next_marker(r, IN_MAIN, 0xFF90);
        if (m == 0xFF90) { r.pos -= 2; break; }
        len = r.u16();
        if (len < 2) bad("marker segment length below 2");
        end = r.pos + len - 2;
        r.need(len - 2);
        read_marker(h, h.main, r, m, end, false);
    }
    if (!h.have_cod) bad("no COD marker in the main header");
    if (!h.have_qcd) bad("no QCD marker in the main header");
    merge_ppm(h);
    h.main.coc_set.assign(nc, 0);
    h.main.qcc_set.assign(nc, 0);
    for (int i = 0; i < nc; ++i) check_cblk_style(h.main.coding[i].style);
    return h;
}

// ---------------------------------------------------------------- tiles

struct TileData {
    TileCoding coding;
    std::vector<uint8_t> bytes;
    int parts_seen = 0, parts_total = 0, started = 0;
    int ready = 0;                     // when its last tile-part by TNsot came (1, 2, ...)
};

// Walks the tile-parts; returns per tile its coding and its packet bytes
// (a tile with none is left empty). The codestream's end is read as
// OpenJPEG 2.5 reads it: after the last tile-part, EOC; or, when its
// tile-parts left some TNsot unknown, the end of the data; or any two bytes
// that end the data (when some TNsot is unknown, OpenJPEG then decodes the
// last tile-part's tile alone).
std::vector<TileData> parse_tiles(Header& h, Reader& r) {
    std::vector<TileData> tiles(size_t(h.ntx) * h.nty);
    int nc = int(h.comps.size());
    int readied = 0;
    auto counted = [&]() {            // every tile has all its tile-parts, by TNsot
        for (auto& td : tiles)
            if (!td.parts_total || td.parts_seen != td.parts_total) return false;
        return true;
    };
    auto all_started = [&]() {
        for (auto& td : tiles)
            if (!td.started) return false;
        return true;
    };
    for (;;) {
        uint32_t m = r.u16();
        if (m == 0xFFD9) break;
        if (m != 0xFF90) bad("expected SOT or EOC");
        int64_t sot_at = r.pos - 2;
        if (r.u16() != 10) bad("SOT length is not 10");
        uint32_t isot = r.u16();
        int64_t psot = r.u32();
        uint32_t tpsot = r.u8(), tnsot = r.u8();
        if (isot >= tiles.size()) bad("SOT tile index out of range");
        TileData& td = tiles[isot];
        if (!td.started) {
            td.coding = h.main;
            td.started = 1;
        }
        if (tpsot != uint32_t(td.parts_seen)) bad("tile-parts out of order");
        if (tnsot) {
            if (td.parts_total && int(tnsot) != td.parts_total) bad("TNsot changes between tile-parts");
            td.parts_total = tnsot;
        }
        bool first = td.parts_seen == 0;
        td.parts_seen++;
        if (td.parts_total && td.parts_seen == td.parts_total && !td.ready) td.ready = ++readied;
        int64_t part_end = psot ? sot_at + psot : -1;
        if (psot && psot < 14) bad("Psot below 14");
        if (psot && part_end > r.n) bad("codestream truncated inside a tile-part");
        for (;;) {
            uint32_t mm = next_marker(r, IN_TILE, 0xFF93);
            if (mm == 0xFF93) break;
            int64_t len = r.u16();
            if (len < 2) bad("marker segment length below 2");
            int64_t end = r.pos + len - 2;
            r.need(len - 2);
            if (!first && (mm == 0xFF52 || mm == 0xFF53 || mm == 0xFF5C || mm == 0xFF5D))
                bad("COD/COC/QCD/QCC outside a tile's first tile-part");
            read_marker(h, td.coding, r, mm, end, true);
        }
        int64_t data_end;
        if (psot) {
            data_end = part_end;
            if (data_end < r.pos) bad("tile-part header runs past Psot");
        } else {
            // The last tile-part of the codestream: its data runs to the
            // last two bytes.
            if (r.n - r.pos < 2) bad("codestream truncated inside a tile-part");
            data_end = r.n - 2;
        }
        td.bytes.insert(td.bytes.end(), r.p + r.pos, r.p + data_end);
        r.pos = data_end;
        int64_t left = r.n - r.pos;
        if (left < 2) {
            if (counted() || !all_started()) bad("codestream does not end with EOC");
            break;
        }
        uint32_t next = (uint32_t(r.p[r.pos]) << 8) | r.p[r.pos + 1];
        if (next == 0xFFD9) break;
        if (left == 2) {
            if (!counted())
                for (size_t t = 0; t < tiles.size(); ++t)
                    if (t != isot) tiles[t].started = 0;
            break;
        }
        if (next == 0xFF90 && counted()) break;
        if (next != 0xFF90) bad("expected SOT or EOC");
    }
    for (size_t t = 0; t < tiles.size(); ++t) {
        TileData& td = tiles[t];
        if (!td.started) continue;
        for (int i = 0; i < nc; ++i) check_cblk_style(td.coding.coding[i].style);
    }
    return tiles;
}

// ---------------------------------------------------------------- tier 2

struct Bits {
    const uint8_t* p;
    int64_t pos, end;
    uint32_t buf = 0;
    int ct = 0;
    Bits(const uint8_t* d, int64_t start, int64_t e) : p(d), pos(start), end(e) {}
    void byte_in() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (pos < end) buf |= p[pos++];   // past the end: zero bits, as OpenJPEG reads
    }
    uint32_t bit() {
        if (ct == 0) byte_in();
        --ct;
        return (buf >> ct) & 1;
    }
    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = n - 1; i >= 0; --i) v |= bit() << i;
        return v;
    }
    // OpenJPEG's opj_bio_inalign: false when a stuffed byte lies past the end.
    bool align() {
        bool ok = true;
        if ((buf & 0xff) == 0xff) {
            ok = pos < end;
            byte_in();
        }
        ct = 0;
        return ok;
    }
};

// A run of bytes being read: a tile's packets, or packed packet headers.
struct Stream {
    const uint8_t* p;
    int64_t pos, end;
};

struct TagTree {
    struct Node { int parent, value, low; };
    std::vector<Node> nodes;
    int w = 0, h = 0;
    void init(int ww, int hh) {
        w = ww; h = hh;
        nodes.clear();
        if (w == 0 || h == 0) return;
        std::vector<int> lw{w}, lh{h};
        while (lw.back() * lh.back() > 1) {
            lw.push_back((lw.back() + 1) / 2);
            lh.push_back((lh.back() + 1) / 2);
        }
        std::vector<int> base(lw.size());
        int total = 0;
        for (size_t l = 0; l < lw.size(); ++l) { base[l] = total; total += lw[l] * lh[l]; }
        nodes.assign(total, Node{-1, 999, 0});
        for (size_t l = 0; l + 1 < lw.size(); ++l)
            for (int j = 0; j < lh[l]; ++j)
                for (int i = 0; i < lw[l]; ++i)
                    nodes[base[l] + j * lw[l] + i].parent = base[l + 1] + (j / 2) * lw[l + 1] + i / 2;
    }
    // 1 when the leaf's value is below the threshold (OpenJPEG's opj_tgt_decode).
    int decode(Bits& b, int leaf, int threshold) {
        int stk[64], sp = 0;
        int node = leaf;
        while (nodes[node].parent >= 0) { stk[sp++] = node; node = nodes[node].parent; }
        int low = 0;
        for (;;) {
            Node& nd = nodes[node];
            if (low > nd.low) nd.low = low; else low = nd.low;
            while (low < threshold && low < nd.value) {
                if (b.bit()) nd.value = low;
                else ++low;
            }
            nd.low = low;
            if (sp == 0) break;
            node = stk[--sp];
        }
        return nodes[node].value < threshold ? 1 : 0;
    }
};

// A codeword segment: its most passes, the passes and bytes it has.
struct Segment {
    int most, passes = 0, bytes = 0;
};

struct Block {
    int x0, y0, x1, y1;      // band coordinates
    int included = 0, numbps = 0, lenbits = 3;
    std::vector<uint8_t> data;
    std::vector<Segment> segs;
    // OpenJPEG's opj_t2_init_seg: one pass a segment when each pass is
    // terminated; with the bypass, 10 passes (the MQ-coded cleanup and the
    // three bit-planes below it), then 2 raw (significance, refinement)
    // and 1 MQ (cleanup) in turn; else 109, more than a 30-plane block has.
    void new_segment(int style) {
        int most = 109;
        if (style & TERMALL) most = 1;
        else if ((style & LAZY) && segs.empty()) most = 10;
        else if (style & LAZY) most = segs.back().most == 1 || segs.back().most == 10 ? 2 : 1;
        segs.push_back({most});
    }
};

struct Band {
    int orient = 0;          // 0 LL, 1 HL, 2 LH, 3 HH
    int64_t x0, y0, x1, y1;
    int mb = 0;              // Mb: guard bits + exponent - 1
    float step = 0.f;        // dequantization step (irreversible)
};

struct Precinct {
    struct PBand {
        int cw = 0, ch = 0;
        std::vector<int> blocks;    // indices into the resolution's block list
        TagTree incl, imsb;
    };
    PBand bands[3];
};

struct Resolution {
    int64_t x0, y0, x1, y1;
    int nbands = 0;
    Band bands[3];
    int pw = 0, ph = 0, ppx = 15, ppy = 15;
    std::vector<Precinct> precincts;
    std::vector<Block> blocks[3];
};

struct TileComp {
    int64_t x0, y0, x1, y1;
    int levels = 0;
    std::vector<Resolution> res;
    std::vector<int32_t> idata;     // 5/3
    std::vector<float> fdata;       // 9/7
};

void build_tile_comp(const Coding& cod, const Quant& q, const Comp& cp,
                     int64_t tx0, int64_t ty0, int64_t tx1, int64_t ty1, TileComp& tc) {
    tc.x0 = ceil_div(tx0, cp.dx); tc.y0 = ceil_div(ty0, cp.dy);
    tc.x1 = ceil_div(tx1, cp.dx); tc.y1 = ceil_div(ty1, cp.dy);
    tc.levels = cod.levels;
    int nl = cod.levels;
    tc.res.resize(nl + 1);
    int nbands_total = 3 * nl + 1;
    if (q.style == 1) {
        if (q.expn.size() < 1) bad("QCD lacks the LL step size");
    } else if (int(q.expn.size()) < nbands_total) {
        bad("QCD/QCC has fewer step sizes than bands");
    }
    for (int r = 0; r <= nl; ++r) {
        Resolution& R = tc.res[r];
        int s = nl - r;
        R.x0 = ceil_pow2(tc.x0, s); R.y0 = ceil_pow2(tc.y0, s);
        R.x1 = ceil_pow2(tc.x1, s); R.y1 = ceil_pow2(tc.y1, s);
        R.ppx = cod.ppx[r]; R.ppy = cod.ppy[r];
        int64_t px0 = floor_pow2(R.x0, R.ppx) << R.ppx, py0 = floor_pow2(R.y0, R.ppy) << R.ppy;
        int64_t px1 = ceil_pow2(R.x1, R.ppx) << R.ppx, py1 = ceil_pow2(R.y1, R.ppy) << R.ppy;
        R.pw = R.x0 == R.x1 ? 0 : int((px1 - px0) >> R.ppx);
        R.ph = R.y0 == R.y1 ? 0 : int((py1 - py0) >> R.ppy);
        R.nbands = r == 0 ? 1 : 3;
        int64_t cbgx0, cbgy0;
        int cbgw, cbgh;
        if (r == 0) { cbgx0 = px0; cbgy0 = py0; cbgw = R.ppx; cbgh = R.ppy; }
        else { cbgx0 = ceil_pow2(px0, 1); cbgy0 = ceil_pow2(py0, 1); cbgw = R.ppx - 1; cbgh = R.ppy - 1; }
        int cbw = std::min(cod.cbw, cbgw), cbh = std::min(cod.cbh, cbgh);
        for (int b = 0; b < R.nbands; ++b) {
            Band& B = R.bands[b];
            B.orient = r == 0 ? 0 : b + 1;
            int xob = B.orient & 1, yob = B.orient >> 1;
            if (r == 0) {
                B.x0 = ceil_pow2(tc.x0, nl); B.y0 = ceil_pow2(tc.y0, nl);
                B.x1 = ceil_pow2(tc.x1, nl); B.y1 = ceil_pow2(tc.y1, nl);
            } else {
                int nb = nl - r + 1;
                int64_t ox = int64_t(xob) << (nb - 1), oy = int64_t(yob) << (nb - 1);
                B.x0 = ceil_pow2(tc.x0 - ox, nb); B.y0 = ceil_pow2(tc.y0 - oy, nb);
                B.x1 = ceil_pow2(tc.x1 - ox, nb); B.y1 = ceil_pow2(tc.y1 - oy, nb);
            }
            int bandno = r == 0 ? 0 : 3 * (r - 1) + b + 1;
            int expn, mant;
            if (q.style == 1) {
                // OpenJPEG's derivation: the LL exponent less the level.
                int e0 = q.expn[0];
                expn = bandno == 0 ? e0 : std::max(e0 - (bandno - 1) / 3, 0);
                mant = q.mant[0];
            } else {
                expn = q.expn[bandno];
                mant = q.mant[bandno];
            }
            int gain = cod.wavelet == 0 ? 0 : (B.orient == 0 ? 0 : (B.orient == 3 ? 2 : 1));
            int numbps = cp.prec + gain;
            B.step = float((1.0 + mant / 2048.0) * std::pow(2.0, double(numbps - expn)));
            B.mb = expn + q.guard - 1;
            // Precincts and code-blocks of this band.
            R.precincts.resize(size_t(R.pw) * R.ph);
            std::vector<Block>& blocks = R.blocks[b];
            for (int pj = 0; pj < R.ph; ++pj) {
                for (int pi = 0; pi < R.pw; ++pi) {
                    Precinct::PBand& pb = R.precincts[size_t(pj) * R.pw + pi].bands[b];
                    int64_t cx0 = cbgx0 + (int64_t(pi) << cbgw), cy0 = cbgy0 + (int64_t(pj) << cbgh);
                    int64_t cx1 = cx0 + (int64_t(1) << cbgw), cy1 = cy0 + (int64_t(1) << cbgh);
                    int64_t qx0 = std::max(cx0, B.x0), qy0 = std::max(cy0, B.y0);
                    int64_t qx1 = std::min(cx1, B.x1), qy1 = std::min(cy1, B.y1);
                    int64_t bx0 = floor_pow2(qx0, cbw) << cbw, by0 = floor_pow2(qy0, cbh) << cbh;
                    int64_t bx1 = ceil_pow2(qx1, cbw) << cbw, by1 = ceil_pow2(qy1, cbh) << cbh;
                    pb.cw = bx1 > bx0 ? int((bx1 - bx0) >> cbw) : 0;
                    pb.ch = by1 > by0 ? int((by1 - by0) >> cbh) : 0;
                    if (B.x0 >= B.x1 || B.y0 >= B.y1) pb.cw = pb.ch = 0;
                    pb.incl.init(pb.cw, pb.ch);
                    pb.imsb.init(pb.cw, pb.ch);
                    for (int j = 0; j < pb.ch; ++j) {
                        for (int i = 0; i < pb.cw; ++i) {
                            Block k;
                            int64_t kx0 = bx0 + (int64_t(i) << cbw), ky0 = by0 + (int64_t(j) << cbh);
                            k.x0 = int(std::max(kx0, qx0)); k.y0 = int(std::max(ky0, qy0));
                            k.x1 = int(std::min(kx0 + (int64_t(1) << cbw), qx1));
                            k.y1 = int(std::min(ky0 + (int64_t(1) << cbh), qy1));
                            pb.blocks.push_back(int(blocks.size()));
                            blocks.push_back(std::move(k));
                        }
                    }
                }
            }
        }
    }
}

int num_passes(Bits& b) {
    if (!b.bit()) return 1;
    if (!b.bit()) return 2;
    int n = b.read(2);
    if (n != 3) return 3 + n;
    n = b.read(5);
    if (n != 31) return 6 + n;
    return 37 + b.read(7);
}

int floorlog2(uint32_t v) {
    int l = 0;
    while (v > 1) { v >>= 1; ++l; }
    return l;
}

// One packet as OpenJPEG 2.5's opj_t2_read_packet_header and _data read
// it: an SOP marker is stepped over where there is one (a missing one is no
// error); the header comes from ``packed`` (PPM or PPT) or else from the
// packets' own bytes, and must end with an EPH marker when COD says so
// (OpenJPEG fails the tile without it); then the body is appended to the
// included blocks.
void read_packet(Stream& body, Stream* packed, Resolution& R, int prec_no, int layer,
                 const TileCoding& tcod, int style) {
    if (R.pw == 0 || R.ph == 0) return;
    Precinct& P = R.precincts[prec_no];
    const uint8_t* d = body.p;
    if (tcod.sop && body.end - body.pos >= 6 && d[body.pos] == 0xFF && d[body.pos + 1] == 0x91)
        body.pos += 6;
    Stream& head = packed ? *packed : body;
    Bits bits(head.p, head.pos, head.end);
    struct Inc { Block* k; int seg, len; };
    std::vector<Inc> incs;
    bool present = bits.bit();
    if (present) {
        for (int b = 0; b < R.nbands; ++b) {
            Band& B = R.bands[b];
            if (B.x0 >= B.x1 || B.y0 >= B.y1) continue;
            Precinct::PBand& pb = P.bands[b];
            for (int bi = 0; bi < pb.cw * pb.ch; ++bi) {
                Block& k = R.blocks[b][pb.blocks[bi]];
                int inc;
                if (!k.included) inc = pb.incl.decode(bits, bi, layer + 1);
                else inc = bits.bit();
                if (!inc) continue;
                if (!k.included) {
                    int i = 0;
                    while (!pb.imsb.decode(bits, bi, i)) {
                        ++i;
                        if (i > 74) bad("zero bit-plane count out of range");
                    }
                    k.numbps = B.mb + 1 - i;
                    k.lenbits = 3;
                    k.included = 1;
                }
                int np = num_passes(bits);
                while (bits.bit()) k.lenbits++;
                if (k.segs.empty() || k.segs.back().passes == k.segs.back().most) k.new_segment(style);
                // A length per segment the new passes reach.
                for (int seg = int(k.segs.size()) - 1;; ++seg) {
                    Segment& sg = k.segs[seg];
                    int take = std::min(sg.most - sg.passes, np);
                    int nbits = k.lenbits + floorlog2(uint32_t(take));
                    if (nbits > 32) bad("code-block length field above 32 bits");
                    incs.push_back({&k, seg, int(bits.read(nbits))});
                    sg.passes += take;
                    np -= take;
                    if (np <= 0) break;
                    k.new_segment(style);
                }
            }
        }
    }
    if (!bits.align() && present) bad("packet header ends inside a stuffed byte");
    head.pos = bits.pos;
    if (tcod.eph) {
        if (head.end - head.pos < 2) bad("no room for the EPH marker after a packet header");
        if (head.p[head.pos] != 0xFF || head.p[head.pos + 1] != 0x92) bad("expected an EPH marker");
        head.pos += 2;
    }
    for (auto& in : incs) {
        if (body.pos + in.len > body.end) bad("codestream truncated inside a packet body");
        in.k->data.insert(in.k->data.end(), d + body.pos, d + body.pos + in.len);
        in.k->segs[in.seg].bytes += in.len;
        body.pos += in.len;
    }
}

// ---------------------------------------------------------------- tier 1

struct QeRow { uint16_t qe; uint8_t nmps, nlps, sw; };
const QeRow QE[47] = {
    {0x5601, 1, 1, 1}, {0x3401, 2, 6, 0}, {0x1801, 3, 9, 0}, {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0}, {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1}, {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0}, {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

struct MQ {
    const uint8_t* bp;
    uint32_t a, c;
    int ct;
    uint8_t st[19], mps[19];
    void byte_in() {
        uint32_t next = bp[1];
        if (bp[0] == 0xFF) {
            if (next > 0x8F) { c += 0xFF00; ct = 8; }
            else { ++bp; c += next << 9; ct = 7; }
        } else {
            ++bp; c += next << 8; ct = 8;
        }
    }
    void reset_contexts() {
        for (int i = 0; i < 19; ++i) { st[i] = 0; mps[i] = 0; }
        st[0] = 4; st[17] = 3; st[18] = 46;
    }
    // A raw (bypass) segment, OpenJPEG's opj_mqc_raw_init_dec: ``a`` is
    // kept, as there.
    void raw_start(const uint8_t* d) {
        bp = d;
        c = 0;
        ct = 0;
    }
    // One raw bit (opj_mqc_raw_decode): after 0xFF the next byte gives 7
    // bits, and a byte above 0x8F there ends the data (ones follow).
    int raw() {
        if (ct == 0) {
            if (c == 0xFF) {
                if (*bp > 0x8F) { c = 0xFF; ct = 8; }
                else { c = *bp++; ct = 7; }
            } else {
                c = *bp++;
                ct = 8;
            }
        }
        --ct;
        return (c >> ct) & 1;
    }
    // ``d`` holds the segment followed by two 0xFF bytes.
    void start(const uint8_t* d, size_t len) {
        bp = d;
        c = len == 0 ? 0xFFu << 16 : uint32_t(d[0]) << 16;
        byte_in();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void renorm() {
        do {
            if (ct == 0) byte_in();
            a <<= 1; c <<= 1; --ct;
        } while (a < 0x8000);
    }
    int decode(int cx) {
        const QeRow& q = QE[st[cx]];
        int d;
        a -= q.qe;
        if ((c >> 16) < q.qe) {
            if (a < q.qe) { d = mps[cx]; st[cx] = q.nmps; }
            else { d = 1 - mps[cx]; if (q.sw) mps[cx] ^= 1; st[cx] = q.nlps; }
            a = q.qe;
            renorm();
        } else {
            c -= uint32_t(q.qe) << 16;
            if ((a & 0x8000) == 0) {
                if (a < q.qe) { d = 1 - mps[cx]; if (q.sw) mps[cx] ^= 1; st[cx] = q.nlps; }
                else { d = mps[cx]; st[cx] = q.nmps; }
                renorm();
            } else {
                d = mps[cx];
            }
        }
        return d;
    }
};

// Zero-coding context of Table D.1 from the neighbour counts.
int zc_context(int h, int v, int d, int orient) {
    if (orient == 1) std::swap(h, v);   // HL: horizontally high-pass
    if (orient == 3) {
        int hv = h + v;
        if (d >= 3) return 8;
        if (d == 2) return hv >= 1 ? 7 : 6;
        if (d == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
        return hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
    }
    if (h == 2) return 8;
    if (h == 1) return v >= 1 ? 7 : (d >= 1 ? 6 : 5);
    if (v == 2) return 4;
    if (v == 1) return 3;
    return d >= 2 ? 2 : (d == 1 ? 1 : 0);
}

// Per-sample state of a code-block: its own bits and, kept up to date as
// samples turn significant, its eight neighbours' significance and its
// four direct neighbours' signs, so that every context is a table lookup.
enum : uint32_t {
    SIG = 1u << 0, NEG = 1u << 1, VISIT = 1u << 2, REFINED = 1u << 3,
    N_SIG = 1u << 4, S_SIG = 1u << 5, W_SIG = 1u << 6, E_SIG = 1u << 7,
    NW_SIG = 1u << 8, NE_SIG = 1u << 9, SW_SIG = 1u << 10, SE_SIG = 1u << 11,
    N_NEG = 1u << 12, S_NEG = 1u << 13, W_NEG = 1u << 14, E_NEG = 1u << 15,
    NEIGHBOURS = 0xFF0u,
};

struct Luts {
    uint8_t zc[4][256];              // by orientation and the 8 neighbour bits
    uint8_t sc[256], sx[256];        // sign context and XOR bit by the 4+4 sign bits
    Luts() {
        for (int o = 0; o < 4; ++o)
            for (int m = 0; m < 256; ++m) {
                uint32_t f = uint32_t(m) << 4;
                int h = !!(f & W_SIG) + !!(f & E_SIG), v = !!(f & N_SIG) + !!(f & S_SIG);
                int d = !!(f & NW_SIG) + !!(f & NE_SIG) + !!(f & SW_SIG) + !!(f & SE_SIG);
                zc[o][m] = uint8_t(zc_context(h, v, d, o));
            }
        for (int m = 0; m < 256; ++m) {
            auto c = [&](int sig, int neg) { return (m >> sig & 1) ? ((m >> neg & 1) ? -1 : 1) : 0; };
            int hc = c(2, 6) + c(3, 7), vc = c(0, 4) + c(1, 5);   // W, E; N, S
            hc = hc > 0 ? 1 : (hc < 0 ? -1 : 0);
            vc = vc > 0 ? 1 : (vc < 0 ? -1 : 0);
            int cx, xr;
            if (hc == 1) { cx = vc == 1 ? 13 : (vc == 0 ? 12 : 11); xr = 0; }
            else if (hc == 0) { cx = vc == 0 ? 9 : 10; xr = vc == -1 ? 1 : 0; }
            else { cx = vc == -1 ? 13 : (vc == 0 ? 12 : 11); xr = 1; }
            sc[m] = uint8_t(cx);
            sx[m] = uint8_t(xr);
        }
    }
};
const Luts LUT;

// Decodes one code-block's passes into ``out`` (w*h, values 2x the
// magnitude plus the half-step, signed) as OpenJPEG's T1 does
// (opj_t1_decode_cblk), with the code-block style flags and the ROI shift:
// the planes count from roishift + numbps; a segment that starts on a
// significance or refinement pass at or below plane numbps - 4 is raw when
// the bypass is on (OpenJPEG does not count the ROI shift there); RESET
// sets the contexts back after each MQ pass; with VSC a sample turning
// significant on a stripe's first row tells the row above nothing; SEGSYM
// reads four symbols after each cleanup; ERTERM changes nothing decoded
// (OpenJPEG only warns). Then magnitudes at or above 1 << roishift are
// shifted down (opj_t1_clbl_decode_processor).
void decode_block(const Block& k, int orient, int style, int roishift, std::vector<int32_t>& out,
                  std::vector<uint8_t>& seg, std::vector<uint32_t>& f) {
    int w = k.x1 - k.x0, h = k.y1 - k.y0;
    out.assign(size_t(w) * h, 0);
    int bpno = roishift + k.numbps;
    if (bpno >= 31) bad("more than 30 bit-planes in a code-block");
    if (k.segs.empty() || w <= 0 || h <= 0 || bpno <= 0) return;
    MQ mq;
    const int fw = w + 2;
    f.assign(size_t(fw) * (h + 2), 0);
    uint32_t* base = f.data() + fw + 1;           // sample (0, 0)
    const uint8_t* zc = LUT.zc[orient];
    const bool vsc = style & VSC;
    auto sign_ctx = [](uint32_t g) { return ((g >> 4) & 0xF) | (((g >> 12) & 0xF) << 4); };
    auto set_sig = [&](uint32_t* g, int neg, int y) {
        uint32_t n = neg ? ~0u : 0u;
        *g |= SIG | (n & NEG);
        g[-1] |= E_SIG | (n & E_NEG);
        g[1] |= W_SIG | (n & W_NEG);
        if (!vsc || (y & 3)) {
            g[-fw] |= S_SIG | (n & S_NEG);
            g[-fw - 1] |= SE_SIG;
            g[-fw + 1] |= SW_SIG;
        }
        g[fw] |= N_SIG | (n & N_NEG);
        g[fw - 1] |= NE_SIG;
        g[fw + 1] |= NW_SIG;
    };
    auto decode_sign = [&](uint32_t g) {
        int m = sign_ctx(g);
        return mq.decode(LUT.sc[m]) ^ LUT.sx[m];
    };
    // Each segment's bytes with two 0xFF after them; the contexts carry on.
    mq.reset_contexts();
    size_t seg_at = 0;
    int pass_type = 2;
    for (const Segment& sgm : k.segs) {
        bool raw = (style & LAZY) && bpno <= k.numbps - 4 && pass_type < 2;
        seg.assign(k.data.begin() + seg_at, k.data.begin() + seg_at + sgm.bytes);
        seg.push_back(0xFF);
        seg.push_back(0xFF);
        if (raw) mq.raw_start(seg.data());
        else mq.start(seg.data(), size_t(sgm.bytes));
        seg_at += sgm.bytes;
        for (int p = 0; p < sgm.passes && bpno >= 1; ++p) {
            int32_t one = int32_t(1) << bpno, half = one >> 1, oneplushalf = one | half;
            if (pass_type == 0) {          // significance propagation
                for (int y0 = 0; y0 < h; y0 += 4) {
                    int y1 = std::min(y0 + 4, h);
                    for (int x = 0; x < w; ++x)
                        for (int y = y0; y < y1; ++y) {
                            uint32_t* g = base + y * fw + x;
                            if ((*g & SIG) || !(*g & NEIGHBOURS)) continue;
                            if (raw ? mq.raw() : mq.decode(zc[(*g >> 4) & 0xFF])) {
                                int s = raw ? mq.raw() : decode_sign(*g);
                                out[size_t(y) * w + x] = s ? -oneplushalf : oneplushalf;
                                set_sig(g, s, y);
                            }
                            *g |= VISIT;
                        }
                }
            } else if (pass_type == 1) {   // magnitude refinement
                for (int y0 = 0; y0 < h; y0 += 4) {
                    int y1 = std::min(y0 + 4, h);
                    for (int x = 0; x < w; ++x)
                        for (int y = y0; y < y1; ++y) {
                            uint32_t* g = base + y * fw + x;
                            if ((*g & (SIG | VISIT)) != SIG) continue;
                            int bit;
                            if (raw) bit = mq.raw();
                            else bit = mq.decode((*g & REFINED) ? 16 : ((*g & NEIGHBOURS) ? 15 : 14));
                            int32_t& v = out[size_t(y) * w + x];
                            int32_t t = bit ? half : -half;
                            v += v < 0 ? -t : t;
                            *g |= REFINED;
                        }
                }
            } else {                       // cleanup
                for (int y0 = 0; y0 < h; y0 += 4) {
                    int y1 = std::min(y0 + 4, h);
                    for (int x = 0; x < w; ++x) {
                        int y = y0;
                        uint32_t* g0 = base + y0 * fw + x;
                        const uint32_t busy = SIG | VISIT | NEIGHBOURS;
                        if (y1 - y0 == 4 && !(g0[0] & busy) && !(g0[fw] & busy) &&
                            !(g0[2 * fw] & busy) && !(g0[3 * fw] & busy)) {
                            if (!mq.decode(17)) continue;
                            int r = mq.decode(18) << 1;
                            r |= mq.decode(18);
                            y = y0 + r;
                            uint32_t* g = base + y * fw + x;
                            int s = decode_sign(*g);
                            out[size_t(y) * w + x] = s ? -oneplushalf : oneplushalf;
                            set_sig(g, s, y);
                            ++y;
                        }
                        for (; y < y1; ++y) {
                            uint32_t* g = base + y * fw + x;
                            if (*g & (SIG | VISIT)) continue;
                            if (mq.decode(zc[(*g >> 4) & 0xFF])) {
                                int s = decode_sign(*g);
                                out[size_t(y) * w + x] = s ? -oneplushalf : oneplushalf;
                                set_sig(g, s, y);
                            }
                        }
                    }
                }
                for (auto& g : f) g &= ~VISIT;
                if (style & SEGSYM)
                    for (int i = 0; i < 4; ++i) mq.decode(18);
            }
            if ((style & RESET) && !raw) mq.reset_contexts();
            if (++pass_type == 3) { pass_type = 0; --bpno; }
        }
    }
    if (roishift >= 31) {
        std::fill(out.begin(), out.end(), 0);
    } else if (roishift) {
        int32_t thresh = int32_t(1) << roishift;
        for (int32_t& v : out) {
            int32_t mag = v < 0 ? -v : v;
            if (mag >= thresh) v = v < 0 ? -(mag >> roishift) : mag >> roishift;
        }
    }
}

// ---------------------------------------------------------------- DWT

// OpenJPEG 2.5's 9/7 constants and its lifting (opj_v8dwt_decode).
const float DWT_ALPHA = -1.586134342f;
const float DWT_BETA = -0.052980118f;
const float DWT_GAMMA = 0.882911075f;
const float DWT_DELTA = 0.443506852f;
const float DWT_K = 1.230174105f;
const float DWT_TWO_INVK = 1.625732422f;

// The 1-D transforms run on ``nl`` signals at once, interleaved sample by
// sample (w[i * nl + lane]); each lane's arithmetic is the single signal's.
// w: interleaved samples (lows at even positions when cas is 0).
// Sample i of a step sits at index first + 2i and takes its neighbours at
// first + 2i -/+ 1, mirrored at the ends; past ``m`` only the left one,
// doubled (OpenJPEG's opj_v8dwt_decode_step2).
void lift_step(float* w, int n, int nl, int first, int m, int end, float c) {
    for (int i = 0; i < end; ++i) {
        int at = first + 2 * i;
        float* x = w + size_t(at) * nl;
        if (i < m) {
            const float* l = w + size_t(at - 1 >= 0 ? at - 1 : at + 1) * nl;
            const float* r = w + size_t(at + 1 < n ? at + 1 : at - 1) * nl;
            for (int k = 0; k < nl; ++k) x[k] = x[k] + ((l[k] + r[k]) * c);
        } else {
            const float* l = w + size_t(at - 1) * nl;
            for (int k = 0; k < nl; ++k) x[k] = x[k] + l[k] * (c + c);
        }
    }
}

void idwt97_1d(float* w, int n, int nl, int cas) {
    int sn = cas ? n / 2 : (n + 1) / 2;
    int dn = n - sn;
    if (n == 1) return;
    int a = cas, b = 1 - cas;
    for (int i = 0; i < sn; ++i)
        for (int k = 0; k < nl; ++k) w[size_t(a + 2 * i) * nl + k] *= DWT_K;
    for (int i = 0; i < dn; ++i)
        for (int k = 0; k < nl; ++k) w[size_t(b + 2 * i) * nl + k] *= DWT_TWO_INVK;
    lift_step(w, n, nl, a, std::min(sn, dn - a), sn, -DWT_DELTA);
    lift_step(w, n, nl, b, std::min(dn, sn - b), dn, -DWT_GAMMA);
    lift_step(w, n, nl, a, std::min(sn, dn - a), sn, -DWT_BETA);
    lift_step(w, n, nl, b, std::min(dn, sn - b), dn, -DWT_ALPHA);
}

void idwt53_1d(int32_t* w, int n, int nl, int cas) {
    if (n == 1) {
        if (cas)
            for (int k = 0; k < nl; ++k) w[k] /= 2;
        return;
    }
    for (int step = 0; step < 2; ++step)
        for (int at = (cas ^ step) ? 1 : 0; at < n; at += 2) {
            int32_t* x = w + size_t(at) * nl;
            const int32_t* l = w + size_t(at - 1 >= 0 ? at - 1 : at + 1) * nl;
            const int32_t* r = w + size_t(at + 1 < n ? at + 1 : at - 1) * nl;
            if (step == 0)
                for (int k = 0; k < nl; ++k) x[k] -= (l[k] + r[k] + 2) >> 2;
            else
                for (int k = 0; k < nl; ++k) x[k] += (l[k] + r[k]) >> 1;
        }
}

// In-place inverse DWT of a tile-component stored row-major with stride
// ``tw``: at each level the lows sit first in each row and column. Rows
// first, then columns (OpenJPEG's order: the float results depend on it),
// each in groups of LANES signals.
template <typename T, typename F1>
void idwt_2d(T* d, int64_t tw, const TileComp& tc, F1 one_d) {
    constexpr int LANES = 16;
    std::vector<T> buf;
    for (int r = 1; r <= tc.levels; ++r) {
        const Resolution& R = tc.res[r];
        const Resolution& L = tc.res[r - 1];
        int rw = int(R.x1 - R.x0), rh = int(R.y1 - R.y0);
        int sw = int(L.x1 - L.x0), sh = int(L.y1 - L.y0);
        int casx = int(R.x0 & 1), casy = int(R.y0 & 1);
        buf.resize(size_t(std::max(rw, rh)) * LANES);
        for (int y = 0; rw > 0 && y < rh; y += LANES) {
            int nl = std::min(LANES, rh - y);
            for (int k = 0; k < nl; ++k) {
                const T* row = d + (y + k) * tw;
                for (int i = 0; i < sw; ++i) buf[size_t(casx + 2 * i) * nl + k] = row[i];
                for (int i = 0; i < rw - sw; ++i) buf[size_t(1 - casx + 2 * i) * nl + k] = row[sw + i];
            }
            one_d(buf.data(), rw, nl, casx);
            for (int k = 0; k < nl; ++k) {
                T* row = d + (y + k) * tw;
                for (int i = 0; i < rw; ++i) row[i] = buf[size_t(i) * nl + k];
            }
        }
        for (int x = 0; rh > 0 && x < rw; x += LANES) {
            int nl = std::min(LANES, rw - x);
            for (int i = 0; i < rh; ++i) {
                const T* src = d + i * tw + x;
                int at = i < sh ? casy + 2 * i : 1 - casy + 2 * (i - sh);
                std::copy(src, src + nl, buf.begin() + size_t(at) * nl);
            }
            one_d(buf.data(), rh, nl, casy);
            for (int i = 0; i < rh; ++i)
                std::copy(buf.begin() + size_t(i) * nl, buf.begin() + size_t(i + 1) * nl, d + i * tw + x);
        }
    }
}

// ---------------------------------------------------------------- progression

struct PacketId { int layer, res, comp, prec; };

// Appends the packets of one progression volume (layers [0, lye),
// resolutions [rs, re), components [cs, ce)) in its order, skipping the
// packets an earlier volume gave, as OpenJPEG's packet iterator does.
void volume_packets(const Header& h, const std::vector<TileComp>& tcs, int64_t tx0, int64_t ty0,
                    const Poc& v, std::vector<std::vector<uint8_t>>& seen, int layers,
                    std::vector<PacketId>& out) {
    int nc = int(h.comps.size());
    int ce = std::min(v.ce, nc), lye = std::min(v.lye, layers);
    int maxres = 0;
    for (auto& tc : tcs) maxres = std::max(maxres, tc.levels + 1);
    int re = std::min(v.re, maxres);
    auto emit = [&](int l, int r, int c, int p) {
        uint8_t& s = seen[size_t(c) * 33 + r][size_t(p) * layers + l];
        if (!s) { s = 1; out.push_back({l, r, c, p}); }
    };
    auto add_prec = [&](int l, int r, int c) {
        const Resolution& R = tcs[c].res[r];
        for (int p = 0; p < R.pw * R.ph; ++p) emit(l, r, c, p);
    };
    if (v.order == 0) {               // LRCP
        for (int l = 0; l < lye; ++l)
            for (int r = v.rs; r < re; ++r)
                for (int c = v.cs; c < ce; ++c)
                    if (r <= tcs[c].levels) add_prec(l, r, c);
        return;
    }
    if (v.order == 1) {               // RLCP
        for (int r = v.rs; r < re; ++r)
            for (int l = 0; l < lye; ++l)
                for (int c = v.cs; c < ce; ++c)
                    if (r <= tcs[c].levels) add_prec(l, r, c);
        return;
    }
    // Position-driven orders: every precinct starts at a point of the
    // reference grid (its corner, or the tile's origin for the first row
    // and column); the orders sort precincts by that point.
    struct P { int r, c, p; int64_t x, y; };
    std::vector<P> ps;
    for (int c = v.cs; c < ce; ++c) {
        const TileComp& tc = tcs[c];
        for (int r = v.rs; r <= tc.levels && r < re; ++r) {
            const Resolution& R = tc.res[r];
            if (R.x0 == R.x1 || R.y0 == R.y1) continue;
            int lev = tc.levels - r;
            int64_t sx = int64_t(h.comps[c].dx) << (R.ppx + lev);
            int64_t sy = int64_t(h.comps[c].dy) << (R.ppy + lev);
            int64_t gx0 = floor_pow2(R.x0, R.ppx), gy0 = floor_pow2(R.y0, R.ppy);
            for (int pj = 0; pj < R.ph; ++pj)
                for (int pi = 0; pi < R.pw; ++pi) {
                    int64_t x = std::max<int64_t>(tx0, (gx0 + pi) * sx);
                    int64_t y = std::max<int64_t>(ty0, (gy0 + pj) * sy);
                    ps.push_back({r, c, pj * R.pw + pi, x, y});
                }
        }
    }
    auto key = [&](const P& a) {
        switch (v.order) {
        case 2: return std::make_tuple(int64_t(a.r), a.y, a.x, int64_t(a.c));   // RPCL
        case 3: return std::make_tuple(a.y, a.x, int64_t(a.c), int64_t(a.r));   // PCRL
        default: return std::make_tuple(int64_t(a.c), a.y, a.x, int64_t(a.r));  // CPRL
        }
    };
    std::stable_sort(ps.begin(), ps.end(), [&](const P& a, const P& b) { return key(a) < key(b); });
    for (auto& p : ps)
        for (int l = 0; l < lye; ++l) emit(l, p.r, p.c, p.p);
}

std::vector<PacketId> packet_order(const Header& h, const TileCoding& tcod,
                                   const std::vector<TileComp>& tcs, int64_t tx0, int64_t ty0) {
    int nc = int(h.comps.size());
    std::vector<std::vector<uint8_t>> seen(size_t(nc) * 33);
    for (int c = 0; c < nc; ++c)
        for (int r = 0; r <= tcs[c].levels; ++r)
            seen[size_t(c) * 33 + r].assign(size_t(tcs[c].res[r].pw) * tcs[c].res[r].ph * tcod.layers, 0);
    std::vector<PacketId> out;
    std::vector<Poc> vols = tcod.pocs;
    if (vols.empty()) vols.push_back({0, 0, tcod.layers, 33, nc, tcod.order});
    for (const Poc& v : vols) volume_packets(h, tcs, tx0, ty0, v, seen, tcod.layers, out);
    return out;
}

// Runs fn(first, end) over [0, n) in contiguous shares, on up to eight
// threads (one when ``threaded`` is false); a Fail thrown in any share is
// rethrown here (the first one).
template <typename Fn>
void parallel_for(int n, Fn fn, bool threaded = true) {
    int threads = int(std::min<unsigned>(std::max(1u, std::thread::hardware_concurrency()), 8u));
    threads = threaded ? std::min(threads, n) : 1;
    if (threads <= 1) {
        if (n > 0) fn(0, n);
        return;
    }
    std::vector<std::thread> pool;
    std::vector<Fail> failed(threads, Fail{0, ""});
    for (int t = 0; t < threads; ++t)
        pool.emplace_back([&, t] {
            try {
                fn(int(int64_t(n) * t / threads), int(int64_t(n) * (t + 1) / threads));
            } catch (const Fail& f) {
                failed[t] = f;
            }
        });
    for (auto& th : pool) th.join();
    for (auto& f : failed)
        if (f.code) throw f;
}

// ---------------------------------------------------------------- tile decode

// Tier 2 of one tile into ``tcs``: its packets in their order, their
// headers from ``ppm`` (the codestream's PPM data, read on from one tile to
// the next in OpenJPEG's decode order) or from the tile's PPT data or else
// from the packets.
void tile_tier2(const Header& h, TileData& td, int tile_no, std::vector<TileComp>& tcs, Stream* ppm) {
    // OpenJPEG keeps no buffer for a tile whose tile-parts hold no byte
    // after SOD (all its headers packed, no SOP), and fails its decode.
    if (td.bytes.empty()) bad("a tile with no bytes after its SOD markers");
    int nc = int(h.comps.size());
    int p = tile_no % h.ntx, q = tile_no / h.ntx;
    int64_t tx0 = std::max(h.xt0 + p * h.xt, h.x0), ty0 = std::max(h.yt0 + q * h.yt, h.y0);
    int64_t tx1 = std::min(h.xt0 + (p + 1) * h.xt, h.xsiz), ty1 = std::min(h.yt0 + (q + 1) * h.yt, h.ysiz);
    TileCoding& tcod = td.coding;
    tcs.assign(nc, TileComp());
    for (int c = 0; c < nc; ++c) {
        const Coding& cod = tcod.coding[c];
        if (cod.wavelet > 1) refuse("JPEG 2000 Part 2 arbitrary wavelet kernels");
        build_tile_comp(cod, tcod.quant[c], h.comps[c], tx0, ty0, tx1, ty1, tcs[c]);
    }
    std::vector<uint8_t> ppt;
    for (const auto& part : tcod.ppt.parts) ppt.insert(ppt.end(), part.begin(), part.end());
    Stream ppt_stream{ppt.data(), 0, int64_t(ppt.size())};
    Stream* packed = ppm ? ppm : (ppt.empty() ? nullptr : &ppt_stream);
    Stream body{td.bytes.data(), 0, int64_t(td.bytes.size())};
    for (const PacketId& id : packet_order(h, tcod, tcs, tx0, ty0))
        read_packet(body, packed, tcs[id.comp].res[id.res], id.prec, id.layer, tcod,
                    tcod.coding[id.comp].style);
}

// Tier 1 onwards of one tile into ``out``; ``threaded`` spreads its
// code-blocks and its components over threads (the caller spreads the tiles
// instead when there are several).
void tile_finish(const Header& h, TileData& td, std::vector<TileComp>& tcs, int32_t* out,
                 int64_t img_w, int64_t img_h, bool threaded) {
    int nc = int(h.comps.size());
    TileCoding& tcod = td.coding;
    // Tier 1 and dequantization, the code-blocks spread over threads (each
    // writes its own part of its component's buffer), then the inverse
    // transform, one component per thread.
    struct Job { TileComp* tc; const Band* band; const Block* block; int64_t offx, offy; int comp; };
    std::vector<Job> jobs;
    for (int c = 0; c < nc; ++c) {
        TileComp& tc = tcs[c];
        int64_t tw = tc.x1 - tc.x0, th = tc.y1 - tc.y0;
        bool rev = tcod.coding[c].wavelet == 1;
        if (rev) tc.idata.assign(size_t(tw * th), 0);
        else tc.fdata.assign(size_t(tw * th), 0.f);
        for (int r = 0; r <= tc.levels; ++r) {
            const Resolution& R = tc.res[r];
            for (int b = 0; b < R.nbands; ++b) {
                const Band& B = R.bands[b];
                // The band's place in the tile buffer: HL right of the low
                // band, LH below it, HH below and right.
                int64_t offx = 0, offy = 0;
                if (r > 0) {
                    if (B.orient & 1) offx = tc.res[r - 1].x1 - tc.res[r - 1].x0;
                    if (B.orient & 2) offy = tc.res[r - 1].y1 - tc.res[r - 1].y0;
                }
                for (const Block& k : R.blocks[b]) jobs.push_back({&tc, &B, &k, offx, offy, c});
            }
        }
    }
    parallel_for(int(jobs.size()), [&](int first, int end) {
        std::vector<int32_t> cb;
        std::vector<uint8_t> seg;
        std::vector<uint32_t> flags;
        for (int j = first; j < end; ++j) {
            const Job& job = jobs[j];
            const Block& k = *job.block;
            const Band& B = *job.band;
            TileComp& tc = *job.tc;
            int64_t tw = tc.x1 - tc.x0;
            float step = 0.5f * B.step;
            bool rev = tcod.coding[job.comp].wavelet == 1;
            decode_block(k, B.orient, tcod.coding[job.comp].style, tcod.roishift[job.comp], cb, seg,
                         flags);
            int w = k.x1 - k.x0, hh = k.y1 - k.y0;
            for (int y = 0; y < hh; ++y)
                for (int x = 0; x < w; ++x) {
                    int64_t at = (k.y0 - B.y0 + job.offy + y) * tw + (k.x0 - B.x0 + job.offx + x);
                    int32_t v = cb[size_t(y) * w + x];
                    if (rev) tc.idata[at] = v / 2;
                    else tc.fdata[at] = float(v) * step;
                }
        }
    }, threaded);
    parallel_for(nc, [&](int first, int end) {
        for (int c = first; c < end; ++c) {
            TileComp& tc = tcs[c];
            if (tcod.coding[c].wavelet == 1) idwt_2d(tc.idata.data(), tc.x1 - tc.x0, tc, idwt53_1d);
            else idwt_2d(tc.fdata.data(), tc.x1 - tc.x0, tc, idwt97_1d);
        }
    }, threaded);
    // Multiple-component transform on the first three components.
    if (tcod.mct == 1) {
        if (nc < 3) bad("MCT with fewer than three components");
        bool rev = tcod.coding[0].wavelet == 1;
        for (int c = 1; c < 3; ++c)
            if (tcs[c].x1 - tcs[c].x0 != tcs[0].x1 - tcs[0].x0 || tcs[c].y1 - tcs[c].y0 != tcs[0].y1 - tcs[0].y0
                || (tcod.coding[c].wavelet == 1) != rev)
                bad("MCT over components of different sizes or transforms");
        size_t n = size_t((tcs[0].x1 - tcs[0].x0) * (tcs[0].y1 - tcs[0].y0));
        if (rev) {
            int32_t* c0 = tcs[0].idata.data();
            int32_t* c1 = tcs[1].idata.data();
            int32_t* c2 = tcs[2].idata.data();
            for (size_t i = 0; i < n; ++i) {
                int32_t y = c0[i], u = c1[i], v = c2[i];
                int32_t g = y - ((u + v) >> 2);
                c0[i] = v + g;
                c1[i] = g;
                c2[i] = u + g;
            }
        } else {
            float* c0 = tcs[0].fdata.data();
            float* c1 = tcs[1].fdata.data();
            float* c2 = tcs[2].fdata.data();
            for (size_t i = 0; i < n; ++i) {
                float y = c0[i], u = c1[i], v = c2[i];
                float r = y + (v * 1.402f);
                float g = (y - (u * 0.34413f)) - (v * 0.71414f);
                float bl = y + (u * 1.772f);
                c0[i] = r; c1[i] = g; c2[i] = bl;
            }
        }
    } else if (tcod.mct > 1) {
        bad("MCT value " + std::to_string(tcod.mct));
    }
    // DC level shift, clamp and placement.
    for (int c = 0; c < nc; ++c) {
        TileComp& tc = tcs[c];
        const Comp& cp = h.comps[c];
        int64_t tw = tc.x1 - tc.x0, th = tc.y1 - tc.y0;
        int64_t mn, mx, shift;
        if (cp.sgnd) { mn = -(int64_t(1) << (cp.prec - 1)); mx = (int64_t(1) << (cp.prec - 1)) - 1; shift = 0; }
        else { mn = 0; mx = (int64_t(1) << cp.prec) - 1; shift = int64_t(1) << (cp.prec - 1); }
        bool rev = tcod.coding[c].wavelet == 1;
        const int32_t* di = tc.idata.data();
        int32_t* plane = out + size_t(c) * img_w * img_h;
        for (int64_t y = 0; y < th; ++y)
            for (int64_t x = 0; x < tw; ++x) {
                int64_t v;
                if (rev) {
                    v = std::min(std::max(int64_t(di[y * tw + x]) + shift, mn), mx);
                } else {
                    float f = tc.fdata[y * tw + x];
                    if (f > float(INT32_MAX)) v = mx;
                    else if (f < float(INT32_MIN)) v = mn;
                    else v = std::min(std::max(int64_t(std::nearbyint(f)) + shift, mn), mx);
                }
                plane[(tc.y0 + y) * img_w + tc.x0 + x] = int32_t(v);
            }
    }
}

void put_msg(char* msg, int cap, const std::string& s) {
    if (cap <= 0) return;
    std::snprintf(msg, size_t(cap), "%s", s.c_str());
}

}  // namespace

extern "C" {

// info: [ncomp, xsiz, ysiz, x0, y0, then per component prec, sgnd, dx, dy]
int dg_j2k_info(const uint8_t* cs, int64_t n, int32_t* info, int32_t cap, char* msg, int32_t msg_cap) {
    try {
        Reader r(cs, n);
        Header h = parse_main(r);
        int nc = int(h.comps.size());
        if (cap < 5 + 4 * nc) bad("too many components");
        info[0] = nc;
        info[1] = int32_t(h.xsiz); info[2] = int32_t(h.ysiz);
        info[3] = int32_t(h.x0); info[4] = int32_t(h.y0);
        for (int c = 0; c < nc; ++c) {
            info[5 + 4 * c] = h.comps[c].prec;
            info[6 + 4 * c] = h.comps[c].sgnd;
            info[7 + 4 * c] = h.comps[c].dx;
            info[8 + 4 * c] = h.comps[c].dy;
        }
        return 0;
    } catch (const Fail& f) {
        put_msg(msg, msg_cap, f.msg);
        return f.code;
    }
}

// out: int32 [ncomp][ysiz][xsiz], zeroed; the image origin is 0 and no
// component is subsampled (the caller checks with dg_j2k_info first).
int dg_j2k_decode(const uint8_t* cs, int64_t n, int32_t* out, char* msg, int32_t msg_cap) {
    try {
        Reader r(cs, n);
        Header h = parse_main(r);
        if (h.x0 || h.y0) bad("image origin is not 0");
        for (auto& c : h.comps)
            if (c.dx != 1 || c.dy != 1) bad("subsampled component");
        std::vector<TileData> tiles = parse_tiles(h, r);
        std::vector<int> todo;
        for (size_t t = 0; t < tiles.size(); ++t)
            if (tiles[t].started) todo.push_back(int(t));
        bool one = todo.size() == 1;
        std::vector<std::vector<TileComp>> tcs(todo.size());
        if (!h.ppm_headers.empty()) {
            // The PPM headers are read tile after tile as OpenJPEG decodes
            // them: each tile when its last tile-part by TNsot comes, then
            // at the end of the codestream the others by index.
            std::vector<int> order(todo.size());
            for (size_t i = 0; i < order.size(); ++i) order[i] = int(i);
            auto when = [&](int i) { int r = tiles[todo[i]].ready; return r ? r : INT32_MAX; };
            std::stable_sort(order.begin(), order.end(), [&](int a, int b) { return when(a) < when(b); });
            Stream ppm{h.ppm_headers.data(), 0, int64_t(h.ppm_headers.size())};
            for (int i : order) tile_tier2(h, tiles[todo[i]], todo[i], tcs[i], &ppm);
        }
        parallel_for(int(todo.size()), [&](int first, int end) {
            for (int i = first; i < end; ++i) {
                if (h.ppm_headers.empty()) tile_tier2(h, tiles[todo[i]], todo[i], tcs[i], nullptr);
                tile_finish(h, tiles[todo[i]], tcs[i], out, h.xsiz, h.ysiz, one);
                tcs[i] = std::vector<TileComp>();
            }
        });
        return 0;
    } catch (const Fail& f) {
        put_msg(msg, msg_cap, f.msg);
        return f.code;
    }
}

}  // extern "C"
