// Native gate synthesis (the port's copy of the JAX package's
// mythril_tpu/native/blast.cpp, unchanged below this header): the
// Tseitin circuit builders behind the bit-blaster (adder, multiplier,
// divider, comparators, shifters). The Python Blaster walks the term
// DAG and makes ONE call here per term; this side owns the variable
// counter, the gate cache, and the flat 0-separated DIMACS clause
// store the CDCL session loads deltas from (zero-copy: the store
// pointer is exported, see bl_flat_ptr).
//
// CONTRACT: the CNF produced here is bit-for-bit identical to the
// pure-Python PyBlaster (laser/smt/solver/bitblast.py): same variable
// numbering, same clause order, same simplifications. Identical CNF
// means identical CDCL behavior, identical models, and byte-identical
// reports; tests/test_torch_blast.py asserts stream equality over
// randomized term DAGs, against PyBlaster and the JAX package's native
// blaster. Any change to a simplification rule must land in BOTH
// implementations.
//
// Built with cdcl.cpp into _build/libmythril_torch_host.so by g++ at
// first use (mythril_tpu_torch/native/build.py:build_host).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <unordered_map>
#include <vector>

namespace {

constexpr int32_t TRUE_LIT = 1;
constexpr int32_t FALSE_LIT = -1;

static inline uint64_t mix(uint64_t h, uint64_t v) {
    h ^= v + 0x9e3779b97f4a7c15ULL + (h << 6) + (h >> 2);
    return h;
}

struct Key2 {
    int32_t tag, a, b;
    bool operator==(const Key2 &o) const {
        return tag == o.tag && a == o.a && b == o.b;
    }
};
struct Key2Hash {
    size_t operator()(const Key2 &k) const {
        uint64_t h = 1469598103934665603ULL;
        h = mix(h, (uint32_t)k.tag);
        h = mix(h, (uint32_t)k.a);
        h = mix(h, (uint32_t)k.b);
        return (size_t)h;
    }
};
struct Key3 {
    int32_t tag, a, b, c;
    bool operator==(const Key3 &o) const {
        return tag == o.tag && a == o.a && b == o.b && c == o.c;
    }
};
struct Key3Hash {
    size_t operator()(const Key3 &k) const {
        uint64_t h = 1469598103934665603ULL;
        h = mix(h, (uint32_t)k.tag);
        h = mix(h, (uint32_t)k.a);
        h = mix(h, (uint32_t)k.b);
        h = mix(h, (uint32_t)k.c);
        return (size_t)h;
    }
};
struct VecHash {
    size_t operator()(const std::vector<int32_t> &v) const {
        uint64_t h = 1469598103934665603ULL;
        for (int32_t x : v) h = mix(h, (uint32_t)x);
        return (size_t)h;
    }
};

enum { TAG_XOR = 1, TAG_ITE = 2, TAG_MAJ = 3 };

struct Blaster {
    int32_t nvars = 1;  // var 1 = constant TRUE
    std::vector<int32_t> flat;
    std::unordered_map<std::vector<int32_t>, int32_t, VecHash> and_cache;
    std::unordered_map<Key2, int32_t, Key2Hash> xor_cache;
    std::unordered_map<Key3, int32_t, Key3Hash> k3_cache;  // ite + maj
    std::vector<int32_t> scratch;

    Blaster() {
        flat.reserve(1 << 20);
        flat.push_back(TRUE_LIT);
        flat.push_back(0);
    }

    int32_t new_var() { return ++nvars; }

    void emit1(int32_t a) {
        flat.push_back(a);
        flat.push_back(0);
    }
    void emit2(int32_t a, int32_t b) {
        flat.push_back(a);
        flat.push_back(b);
        flat.push_back(0);
    }
    void emit3(int32_t a, int32_t b, int32_t c) {
        flat.push_back(a);
        flat.push_back(b);
        flat.push_back(c);
        flat.push_back(0);
    }

    // Blaster.add: drop clauses containing TRUE, strip FALSE literals.
    void add_clause(const int32_t *lits, int n) {
        size_t start = flat.size();
        for (int i = 0; i < n; i++) {
            int32_t l = lits[i];
            if (l == TRUE_LIT) {
                flat.resize(start);
                return;
            }
            if (l == FALSE_LIT) continue;
            flat.push_back(l);
        }
        flat.push_back(0);
    }

    int32_t g_and(const int32_t *ins, int n) {
        scratch.clear();
        for (int i = 0; i < n; i++) {
            int32_t l = ins[i];
            if (l == FALSE_LIT) return FALSE_LIT;
            if (l == TRUE_LIT) continue;
            scratch.push_back(l);
        }
        if (scratch.empty()) return TRUE_LIT;
        // sorted(set(lits)): signed ascending, deduplicated
        std::sort(scratch.begin(), scratch.end());
        scratch.erase(std::unique(scratch.begin(), scratch.end()),
                      scratch.end());
        if (scratch.size() == 1) return scratch[0];
        for (int32_t l : scratch) {
            if (std::binary_search(scratch.begin(), scratch.end(), -l))
                return FALSE_LIT;
        }
        auto it = and_cache.find(scratch);
        if (it != and_cache.end()) return it->second;
        int32_t o = new_var();
        for (int32_t l : scratch) emit2(-o, l);
        flat.push_back(o);
        for (int32_t l : scratch) flat.push_back(-l);
        flat.push_back(0);
        and_cache.emplace(scratch, o);
        return o;
    }

    int32_t g_and2(int32_t a, int32_t b) {
        int32_t ins[2] = {a, b};
        return g_and(ins, 2);
    }
    int32_t g_and3(int32_t a, int32_t b, int32_t c) {
        int32_t ins[3] = {a, b, c};
        return g_and(ins, 3);
    }

    int32_t g_or(const int32_t *ins, int n) {
        scratch.reserve((size_t)n);
        std::vector<int32_t> neg(n);
        for (int i = 0; i < n; i++) neg[i] = -ins[i];
        return -g_and(neg.data(), n);
    }
    int32_t g_or2(int32_t a, int32_t b) {
        int32_t ins[2] = {-a, -b};
        return -g_and(ins, 2);
    }

    int32_t g_xor(int32_t a, int32_t b) {
        if (a == FALSE_LIT) return b;
        if (b == FALSE_LIT) return a;
        if (a == TRUE_LIT) return -b;
        if (b == TRUE_LIT) return -a;
        if (a == b) return FALSE_LIT;
        if (a == -b) return TRUE_LIT;
        if (std::abs(b) < std::abs(a)) std::swap(a, b);
        Key2 key{TAG_XOR, a, b};
        auto it = xor_cache.find(key);
        if (it != xor_cache.end()) return it->second;
        int32_t o = new_var();
        emit3(-o, a, b);
        emit3(-o, -a, -b);
        emit3(o, -a, b);
        emit3(o, a, -b);
        xor_cache.emplace(key, o);
        return o;
    }

    int32_t g_ite(int32_t c, int32_t a, int32_t b) {
        if (c == TRUE_LIT) return a;
        if (c == FALSE_LIT) return b;
        if (a == b) return a;
        if (a == TRUE_LIT && b == FALSE_LIT) return c;
        if (a == FALSE_LIT && b == TRUE_LIT) return -c;
        if (a == TRUE_LIT) return g_or2(c, b);
        if (a == FALSE_LIT) return g_and2(-c, b);
        if (b == TRUE_LIT) return g_or2(-c, a);
        if (b == FALSE_LIT) return g_and2(c, a);
        Key3 key{TAG_ITE, c, a, b};
        auto it = k3_cache.find(key);
        if (it != k3_cache.end()) return it->second;
        int32_t o = new_var();
        emit3(-o, -c, a);
        emit3(o, -c, -a);
        emit3(-o, c, b);
        emit3(o, c, -b);
        k3_cache.emplace(key, o);
        return o;
    }

    int32_t g_maj(int32_t a, int32_t b, int32_t c) {
        int nt = 0, nf = 0;
        for (int32_t l : {a, b, c}) {
            if (l == TRUE_LIT) nt++;
            else if (l == FALSE_LIT) nf++;
        }
        if (nt + nf >= 2) {
            if (nt >= 2) return TRUE_LIT;
            if (nf >= 2) return FALSE_LIT;
            for (int32_t l : {a, b, c})
                if (l != TRUE_LIT && l != FALSE_LIT) return l;
        }
        if (a == TRUE_LIT) return g_or2(b, c);
        if (a == FALSE_LIT) return g_and2(b, c);
        if (b == TRUE_LIT) return g_or2(a, c);
        if (b == FALSE_LIT) return g_and2(a, c);
        if (c == TRUE_LIT) return g_or2(a, b);
        if (c == FALSE_LIT) return g_and2(a, b);
        int32_t s[3] = {a, b, c};
        std::stable_sort(s, s + 3, [](int32_t x, int32_t y) {
            return std::abs(x) < std::abs(y);
        });
        Key3 key{TAG_MAJ, s[0], s[1], s[2]};
        auto it = k3_cache.find(key);
        if (it != k3_cache.end()) return it->second;
        int32_t o = new_var();
        emit3(-o, a, b);
        emit3(-o, a, c);
        emit3(-o, b, c);
        emit3(o, -a, -b);
        emit3(o, -a, -c);
        emit3(o, -b, -c);
        k3_cache.emplace(key, o);
        return o;
    }

    // ---- word-level builders (mirror bitblast.py exactly) ------------
    // adder: out must hold w lits; returns carry. b must hold >= w lits.
    int32_t adder(const int32_t *a, const int32_t *b, int w, int32_t cin,
                  int32_t *out) {
        int32_t c = cin;
        for (int i = 0; i < w; i++) {
            out[i] = g_xor(g_xor(a[i], b[i]), c);
            c = g_maj(a[i], b[i], c);
        }
        return c;
    }

    void mul(const int32_t *a, int wa, const int32_t *b, int wb,
             int out_w, int32_t *out) {
        std::vector<int32_t> acc((size_t)out_w, FALSE_LIT);
        std::vector<int32_t> row((size_t)out_w);
        std::vector<int32_t> next((size_t)out_w);
        int bi_max = std::min(wb, out_w);
        for (int i = 0; i < bi_max; i++) {
            if (b[i] == FALSE_LIT) continue;
            int aj_max = std::min(wa, out_w - i);
            for (int j = 0; j < i; j++) row[j] = FALSE_LIT;
            for (int j = 0; j < aj_max; j++)
                row[i + j] = g_and2(b[i], a[j]);
            for (int j = i + aj_max; j < out_w; j++) row[j] = FALSE_LIT;
            adder(acc.data(), row.data(), out_w, FALSE_LIT, next.data());
            acc.swap(next);
        }
        std::memcpy(out, acc.data(), sizeof(int32_t) * (size_t)out_w);
    }

    int32_t eq_bits(const int32_t *a, const int32_t *b, int w) {
        std::vector<int32_t> neq((size_t)w);
        for (int i = 0; i < w; i++) neq[i] = -g_xor(a[i], b[i]);
        return g_and(neq.data(), w);
    }

    int32_t ult_bits(const int32_t *a, const int32_t *b, int w) {
        int32_t lt = FALSE_LIT;
        for (int i = 0; i < w; i++) {
            int32_t x = a[i], y = b[i];
            int32_t d = g_xor(x, y);
            int32_t lo = g_and2(-x, y);
            lt = g_ite(d, lo, lt);
        }
        return lt;
    }

    // kind: 0 = shl, 1 = lshr, 2 = ashr
    void shift(const int32_t *a, int w, const int32_t *sh, int shw,
               int kind, int32_t *out) {
        int nstages = 1;
        while ((1 << nstages) < w) nstages++;  // == max(1, (w-1).bit_length())
        if (w <= 1) nstages = 1;
        int32_t fill = (kind == 2) ? a[w - 1] : FALSE_LIT;
        std::vector<int32_t> cur(a, a + w);
        std::vector<int32_t> shifted((size_t)w);
        for (int s = 0; s < nstages; s++) {
            int k = 1 << s;
            int32_t bit = (s < shw) ? sh[s] : FALSE_LIT;
            if (bit == FALSE_LIT) continue;
            for (int i = 0; i < w; i++) {
                if (kind == 0)
                    shifted[i] = (i - k >= 0) ? cur[i - k] : FALSE_LIT;
                else
                    shifted[i] = (i + k < w) ? cur[i + k] : fill;
            }
            for (int i = 0; i < w; i++)
                cur[i] = g_ite(bit, shifted[i], cur[i]);
        }
        int32_t big = FALSE_LIT;
        if (shw > nstages) big = g_or(sh + nstages, shw - nstages);
        if (big != FALSE_LIT) {
            for (int i = 0; i < w; i++) cur[i] = g_ite(big, fill, cur[i]);
        }
        std::memcpy(out, cur.data(), sizeof(int32_t) * (size_t)w);
    }

    // q,r fresh with the division relation (EVM: x/0 = x%0 = 0)
    void divmod(const int32_t *a, const int32_t *b, int w, int32_t *q,
                int32_t *r) {
        for (int i = 0; i < w; i++) q[i] = new_var();
        for (int i = 0; i < w; i++) r[i] = new_var();
        std::vector<int32_t> zeros((size_t)w, FALSE_LIT);
        int32_t b_zero = eq_bits(b, zeros.data(), w);
        int32_t cl[2];
        for (int i = 0; i < w; i++) {
            cl[0] = -b_zero;
            cl[1] = -q[i];
            add_clause(cl, 2);
        }
        for (int i = 0; i < w; i++) {
            cl[0] = -b_zero;
            cl[1] = -r[i];
            add_clause(cl, 2);
        }
        int w2 = 2 * w;
        std::vector<int32_t> q_ext((size_t)w2, FALSE_LIT),
            b_ext((size_t)w2, FALSE_LIT), r_ext((size_t)w2, FALSE_LIT),
            a_ext((size_t)w2, FALSE_LIT);
        std::copy(q, q + w, q_ext.begin());
        std::copy(b, b + w, b_ext.begin());
        std::copy(r, r + w, r_ext.begin());
        std::copy(a, a + w, a_ext.begin());
        std::vector<int32_t> prod((size_t)w2), total((size_t)w2);
        mul(q_ext.data(), w2, b_ext.data(), w2, w2, prod.data());
        adder(prod.data(), r_ext.data(), w2, FALSE_LIT, total.data());
        int32_t rel = eq_bits(total.data(), a_ext.data(), w2);
        int32_t r_lt_b = ult_bits(r, b, w);
        cl[0] = b_zero;
        cl[1] = rel;
        add_clause(cl, 2);
        cl[0] = b_zero;
        cl[1] = r_lt_b;
        add_clause(cl, 2);
    }
};

}  // namespace

extern "C" {

void *bl_new() { return new Blaster(); }
void bl_free(void *h) { delete static_cast<Blaster *>(h); }

int32_t bl_nvars(void *h) { return static_cast<Blaster *>(h)->nvars; }

long long bl_flat_len(void *h) {
    return (long long)static_cast<Blaster *>(h)->flat.size();
}

const int32_t *bl_flat_ptr(void *h) {
    return static_cast<Blaster *>(h)->flat.data();
}

// allocate n consecutive vars; returns the first id
int32_t bl_new_vars(void *h, int32_t n) {
    Blaster *bl = static_cast<Blaster *>(h);
    int32_t first = bl->nvars + 1;
    bl->nvars += n;
    return first;
}

void bl_add_clause(void *h, const int32_t *lits, int32_t n) {
    static_cast<Blaster *>(h)->add_clause(lits, n);
}

int32_t bl_and(void *h, const int32_t *ins, int32_t n) {
    return static_cast<Blaster *>(h)->g_and(ins, n);
}
int32_t bl_or(void *h, const int32_t *ins, int32_t n) {
    return static_cast<Blaster *>(h)->g_or(ins, n);
}
int32_t bl_xor(void *h, int32_t a, int32_t b) {
    return static_cast<Blaster *>(h)->g_xor(a, b);
}
int32_t bl_ite(void *h, int32_t c, int32_t a, int32_t b) {
    return static_cast<Blaster *>(h)->g_ite(c, a, b);
}
int32_t bl_maj(void *h, int32_t a, int32_t b, int32_t c) {
    return static_cast<Blaster *>(h)->g_maj(a, b, c);
}

int32_t bl_adder(void *h, const int32_t *a, const int32_t *b, int32_t w,
                 int32_t cin, int32_t *out) {
    return static_cast<Blaster *>(h)->adder(a, b, w, cin, out);
}

void bl_mul(void *h, const int32_t *a, int32_t wa, const int32_t *b,
            int32_t wb, int32_t out_w, int32_t *out) {
    static_cast<Blaster *>(h)->mul(a, wa, b, wb, out_w, out);
}

int32_t bl_eq(void *h, const int32_t *a, const int32_t *b, int32_t w) {
    return static_cast<Blaster *>(h)->eq_bits(a, b, w);
}
int32_t bl_ult(void *h, const int32_t *a, const int32_t *b, int32_t w) {
    return static_cast<Blaster *>(h)->ult_bits(a, b, w);
}

void bl_shift(void *h, const int32_t *a, int32_t w, const int32_t *sh,
              int32_t shw, int32_t kind, int32_t *out) {
    static_cast<Blaster *>(h)->shift(a, w, sh, shw, kind, out);
}

void bl_divmod(void *h, const int32_t *a, const int32_t *b, int32_t w,
               int32_t *q, int32_t *r) {
    static_cast<Blaster *>(h)->divmod(a, b, w, q, r);
}

void bl_ite_bits(void *h, int32_t c, const int32_t *a, const int32_t *b,
                 int32_t w, int32_t *out) {
    Blaster *bl = static_cast<Blaster *>(h);
    for (int i = 0; i < w; i++) out[i] = bl->g_ite(c, a[i], b[i]);
}

void bl_and_bits(void *h, const int32_t *a, const int32_t *b, int32_t w,
                 int32_t *out) {
    Blaster *bl = static_cast<Blaster *>(h);
    for (int i = 0; i < w; i++) out[i] = bl->g_and2(a[i], b[i]);
}
void bl_or_bits(void *h, const int32_t *a, const int32_t *b, int32_t w,
                int32_t *out) {
    Blaster *bl = static_cast<Blaster *>(h);
    for (int i = 0; i < w; i++) out[i] = bl->g_or2(a[i], b[i]);
}
void bl_xor_bits(void *h, const int32_t *a, const int32_t *b, int32_t w,
                 int32_t *out) {
    Blaster *bl = static_cast<Blaster *>(h);
    for (int i = 0; i < w; i++) out[i] = bl->g_xor(a[i], b[i]);
}

}  // extern "C"
