// The port's host code of the database load (io/dbfile.py): the decode of
// one window of a varint section on several threads.
//
// Compiled by utils/native.py into the port's host library beside the
// shared runtime (native/kmerdb_native.cpp), whose encoders write the
// sections: LEB128, seven bits a byte, low bits first, the high bit set on
// every byte but a value's last.  So a value ends at a byte below 0x80,
// and a stream cut just after such a byte starts a fresh value: a window
// splits into one slice a thread at value ends, each thread counts the
// values of its slice, a prefix sum over the counts places each slice's
// values in the output, and every slice decodes into its place at once.
//
// Exposed as a plain C ABI consumed via ctypes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// run fn(t) for t in [0, nt); the calling thread runs t = 0
template <class F>
void run_parallel(int nt, const F& fn) {
    if (nt <= 1) { fn(0); return; }
    std::vector<std::thread> ths;
    ths.reserve(nt - 1);
    for (int t = 1; t < nt; ++t) ths.emplace_back(fn, t);
    fn(0);
    for (auto& th : ths) th.join();
}

// a value is at most 10 bytes: ceil(64 / 7)
constexpr int kMaxLen = 10;

// One value from p, which the caller knows ends before the slice does;
// nullptr if it runs past kMaxLen bytes.  The first bytes unrolled, as the
// shared runtime's vb_get: each length a straight-line path.
inline const uint8_t* get(const uint8_t* p, uint64_t* v) {
    uint64_t b = p[0];
    if (b < 0x80) { *v = b; return p + 1; }
    uint64_t x = b & 0x7f;
    b = p[1]; x |= (b & 0x7f) << 7;
    if (b < 0x80) { *v = x; return p + 2; }
    b = p[2]; x |= (b & 0x7f) << 14;
    if (b < 0x80) { *v = x; return p + 3; }
    b = p[3]; x |= (b & 0x7f) << 21;
    if (b < 0x80) { *v = x; return p + 4; }
    for (int i = 4; i < kMaxLen; ++i) {
        b = p[i];
        x |= (b & 0x7f) << (7 * i);
        if (b < 0x80) { *v = x; return p + i + 1; }
    }
    return nullptr;
}

// Bytes below 0x80 in [p, end): the values that end there.
int64_t count_ends(const uint8_t* p, const uint8_t* end) {
    int64_t n = 0;
    // eight bytes a step: the clear high bits of a word, counted
    for (; end - p >= 8; p += 8) {
        uint64_t w;
        std::memcpy(&w, p, 8);
        n += __builtin_popcountll(~w & 0x8080808080808080ull);
    }
    for (; p < end; ++p) n += *p < 0x80;
    return n;
}

}  // namespace

extern "C" {

// Decodes the values that end in src[0, nbytes), at most nmax of them,
// into out on nt threads.  kind 0: a v32 section, each value truncated to
// 32 bits into uint32 out; kind 1: a d64 section, deltas summed into
// uint64 out mod 2^64 from *base, which returns the last value written.
// *used returns the bytes that the values written take up: the caller
// carries src[*used, nbytes) into its next window.  Returns the values
// written, or -1 when a value runs past 10 bytes (a corrupt section);
// reads nothing outside src and writes nothing past out[nmax).
int64_t kmerdb_vb_decode_window(int32_t kind, const uint8_t* src,
                                int64_t nbytes, int64_t nmax, void* out,
                                uint64_t* base, int64_t* used, int32_t nt) {
    *used = 0;
    int64_t last = nbytes;  // just past the window's last value
    while (last > 0 && src[last - 1] >= 0x80) --last;
    if (last == 0 || nmax <= 0) return 0;
    if (nt < 1) nt = 1;
    if (nt > last) nt = (int)last;
    // slice t is [cut[t], cut[t + 1]): each cut moved just past a value end
    std::vector<int64_t> cut(nt + 1), cnt(nt), off(nt);
    std::vector<int64_t> wrote(nt, 0), stop(nt, 0), bad(nt, 0);
    std::vector<uint64_t> sum(nt, 0);
    cut[0] = 0;
    cut[nt] = last;
    for (int t = 1; t < nt; ++t) {
        int64_t c = last * t / nt;
        if (c < cut[t - 1]) c = cut[t - 1];
        while (c < last && c > 0 && src[c - 1] >= 0x80) ++c;
        cut[t] = c;
    }
    run_parallel(nt, [&](int t) {
        cnt[t] = count_ends(src + cut[t], src + cut[t + 1]);
    });
    int64_t total = 0;
    for (int t = 0; t < nt; ++t) { off[t] = total; total += cnt[t]; }
    run_parallel(nt, [&](int t) {
        int64_t m = cnt[t];
        if (off[t] + m > nmax) m = nmax - off[t] > 0 ? nmax - off[t] : 0;
        const uint8_t* p = src + cut[t];
        uint64_t v, s = t == 0 ? *base : 0;
        int64_t i = 0;
        if (kind == 0) {
            uint32_t* o = static_cast<uint32_t*>(out) + off[t];
            for (; i < m; ++i) {
                if (!(p = get(p, &v))) break;
                o[i] = (uint32_t)v;
            }
        } else {
            uint64_t* o = static_cast<uint64_t*>(out) + off[t];
            for (; i < m; ++i) {
                if (!(p = get(p, &v))) break;
                s += v;
                o[i] = s;
            }
        }
        bad[t] = i < m;
        wrote[t] = i;
        stop[t] = p ? p - src : 0;
        sum[t] = s;
    });
    for (int t = 0; t < nt; ++t)
        if (bad[t]) return -1;
    int64_t n = total < nmax ? total : nmax;
    if (kind == 1) {
        // each later slice's values move up by the running value before it
        std::vector<uint64_t> add(nt, 0);
        uint64_t run = sum[0];
        for (int t = 1; t < nt; ++t) { add[t] = run; run += sum[t]; }
        run_parallel(nt, [&](int t) {
            if (t == 0 || add[t] == 0) return;
            uint64_t* o = static_cast<uint64_t*>(out) + off[t];
            for (int64_t i = 0; i < wrote[t]; ++i) o[i] += add[t];
        });
        if (n) *base = static_cast<uint64_t*>(out)[n - 1];
    }
    if (total <= nmax) {
        *used = last;
    } else {
        for (int t = 0; t < nt; ++t)
            if (wrote[t]) *used = stop[t];
    }
    return n;
}

}  // extern "C"
