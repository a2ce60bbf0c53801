// The port's C++ data-loader core (lctvqa_torch/native).
//
// Three host-side primitives of batch assembly behind a C ABI, loaded
// with ctypes:
//   - lct_tokenize:       the (\W+)-split tokenizer of lctvqa_torch/text.py
//   - lct_sample_answers: one answer drawn uniformly among each item's
//                         valid answers (splitmix64), and the -1-padded
//                         multi-choice rows
//   - lct_gather_rows:    a batched row gather of uint8 arrays, split over
//                         threads when the batch is large
//
// It computes what the JAX package's core (lctvqa/native/src/native.cpp)
// computes, bit for bit, so that both packages draw the same answer labels
// from the same seed. Built at first use by lctvqa_torch/native/build.py
// (g++ -O3 -shared -fPIC -std=c++17 -pthread) into build/native/.

#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// Tokenize `s` (utf-8) as Python's re.split(r"(\W+)", s.lower()) does for
// ASCII: [a-zA-Z0-9_] are word characters. Bytes >= 0x80 are word
// characters too (a utf-8 sequence stays inside its token), where Python's
// \W splits at some non-ASCII characters ('¿'). Writes the tokens, each
// stripped of whitespace, empty ones dropped, joined by '\n' into `out`
// (cap bytes including the NUL). Returns the token count, -1 on overflow.
int lct_tokenize(const char* s, char* out, int cap) {
    std::string cur;
    std::string result;
    int count = 0;
    bool cur_is_word = false;
    bool have_cur = false;

    auto flush = [&]() -> bool {
        if (!have_cur) return true;
        size_t b = cur.find_first_not_of(" \t\r\n\f\v");
        if (b == std::string::npos) { cur.clear(); have_cur = false;
                                      return true; }
        size_t e = cur.find_last_not_of(" \t\r\n\f\v");
        std::string tok = cur.substr(b, e - b + 1);
        if (!result.empty()) result += '\n';
        result += tok;
        ++count;
        cur.clear();
        have_cur = false;
        return true;
    };

    for (const char* p = s; *p; ++p) {
        unsigned char c = static_cast<unsigned char>(*p);
        char lc = static_cast<char>(std::tolower(c));
        bool is_word = (std::isalnum(c) != 0) || c == '_' || c >= 0x80;
        if (!have_cur || is_word != cur_is_word) {
            if (!flush()) return -1;
            cur_is_word = is_word;
            have_cur = true;
        }
        cur += lc;
    }
    if (!flush()) return -1;
    if (static_cast<int>(result.size()) + 1 > cap) return -1;
    std::memcpy(out, result.c_str(), result.size() + 1);
    return count;
}

// splitmix64: one 64-bit draw per call from a 64-bit state.
static inline uint64_t splitmix64(uint64_t* state) {
    uint64_t z = (*state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}

// enc_ans: uint8 [b, a], each item's count per answer. labels[i] is the
// (r % n_valid)-th valid (count > 0) column for the item's draw r, or
// unk_idx where the item has none (and then no draw is made); mc[i] holds
// the item's first max_num_ans valid columns, -1 padded.
void lct_sample_answers(const uint8_t* enc_ans, int b, int a, int unk_idx,
                        uint64_t seed, int32_t* labels, int32_t* mc,
                        int max_num_ans) {
    uint64_t st = seed ^ 0xA0761D6478BD642Full;
    for (int i = 0; i < b; ++i) {
        const uint8_t* row = enc_ans + static_cast<int64_t>(i) * a;
        int n_valid = 0;
        for (int j = 0; j < a; ++j) {
            if (row[j] > 0) {
                if (n_valid < max_num_ans) mc[i * max_num_ans + n_valid] = j;
                ++n_valid;
            }
        }
        for (int j = n_valid < max_num_ans ? n_valid : max_num_ans;
             j < max_num_ans; ++j)
            mc[i * max_num_ans + j] = -1;
        if (n_valid == 0) {
            labels[i] = unk_idx;
            continue;
        }
        uint64_t r = splitmix64(&st);
        int pick = static_cast<int>(r % static_cast<uint64_t>(n_valid));
        int seen = 0;
        int lab = unk_idx;
        for (int j = 0; j < a; ++j) {
            if (row[j] > 0 && seen++ == pick) { lab = j; break; }
        }
        labels[i] = lab;
    }
}

// dst[i] = src[rows[i]], item_bytes bytes a row. The copy is bound by
// memory bandwidth; num_threads (the loader's num_workers) splits the
// batch into contiguous ranges, one thread each, when it is at least
// 1 MiB: below that, starting the threads costs more than they save.
void lct_gather_rows(const uint8_t* src, const int32_t* rows, int b,
                     long long item_bytes, uint8_t* dst, int num_threads) {
    auto copy_range = [=](int lo, int hi) {
        for (int i = lo; i < hi; ++i) {
            std::memcpy(dst + static_cast<int64_t>(i) * item_bytes,
                        src + static_cast<int64_t>(rows[i]) * item_bytes,
                        static_cast<size_t>(item_bytes));
        }
    };
    const long long total = static_cast<long long>(b) * item_bytes;
    if (num_threads <= 1 || b < 2 || total < (1 << 20)) {
        copy_range(0, b);
        return;
    }
    int t = num_threads < b ? num_threads : b;
    std::vector<std::thread> threads;
    threads.reserve(t);
    int per = (b + t - 1) / t;
    for (int k = 0; k < t; ++k) {
        int lo = k * per;
        int hi = lo + per < b ? lo + per : b;
        if (lo >= hi) break;
        threads.emplace_back(copy_range, lo, hi);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
