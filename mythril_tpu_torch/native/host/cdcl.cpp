// CDCL SAT solver — the native constraint back end (the port's copy of
// the JAX package's mythril_tpu/native/cdcl.cpp, unchanged below this
// header).
//
// The reference's entire solver layer is z3's C++ engine behind python
// bindings (reference: mythril/laser/smt/solver/solver.py wraps
// z3.Solver). This framework owns the word-level layer in Python
// and delegates only the final CNF decision problem to this solver:
// a minisat-style CDCL with two-watched literals, 1UIP clause
// learning, VSIDS + phase saving, Luby restarts and activity-based
// clause-database reduction. Exposed as a C ABI for ctypes.
//
// Build: with blast.cpp into _build/libmythril_torch_host.so by g++ at
// first use (mythril_tpu_torch/native/build.py:build_host).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

typedef int Lit;  // +-(var+1), DIMACS style externally; internal 2*v+sign

struct Clause {
  float activity = 0.0f;
  int lbd = 0;  // literal block distance at learn time (glue metric)
  bool learnt = false;
  bool deleted = false;
  bool keep_mark = false;
  std::vector<int> lits;  // internal encoding
};

inline int mklit(int var, bool neg) { return 2 * var + (neg ? 1 : 0); }
inline int lit_var(int l) { return l >> 1; }
inline bool lit_neg(int l) { return l & 1; }
inline int lit_not(int l) { return l ^ 1; }

// A watch entry carries a "blocker" literal (the other watched literal
// at attach time): if the blocker is already true the clause is
// satisfied and propagate skips the clause memory entirely — most
// watch-list traffic resolves on this one cached int.
struct Watcher {
  Clause* c;
  int blocker;
  int is_bin;  // binary clause: blocker IS the other literal
};

struct Solver {
  int nvars = 0;
  std::vector<Clause*> clauses;          // problem clauses
  std::vector<Clause*> learnts;          // learnt clauses
  std::vector<std::vector<Watcher>> watches;  // watch lists per literal
  std::vector<int8_t> assigns;           // -1 unset, 0 false, 1 true
  std::vector<int8_t> phase;             // saved phase
  std::vector<Clause*> reason;
  std::vector<int> level;
  std::vector<int> trail;
  std::vector<int> trail_lim;
  std::vector<double> act;               // VSIDS activity
  double var_inc = 1.0;
  double cla_inc = 1.0;
  std::vector<int> order;                // lazy heap: simple activity scan
  size_t qhead = 0;
  bool ok = true;
  int64_t conflicts = 0;
  int64_t propagations = 0;

  // binary heap over activity
  std::vector<int> heap;
  std::vector<int> heap_pos;

  ~Solver() {
    for (auto* c : clauses) delete c;
    for (auto* c : learnts) delete c;
  }

  int new_var() {
    int v = nvars++;
    watches.emplace_back();
    watches.emplace_back();
    assigns.push_back(-1);
    phase.push_back(0);
    reason.push_back(nullptr);
    level.push_back(0);
    act.push_back(0.0);
    heap_pos.push_back(-1);
    heap_insert(v);
    return v;
  }

  // ---- heap ----------------------------------------------------------
  bool heap_lt(int a, int b) { return act[a] > act[b]; }
  void heap_up(int i) {
    int v = heap[i];
    while (i > 0) {
      int p = (i - 1) >> 1;
      if (heap_lt(v, heap[p])) {
        heap[i] = heap[p];
        heap_pos[heap[i]] = i;
        i = p;
      } else
        break;
    }
    heap[i] = v;
    heap_pos[v] = i;
  }
  void heap_down(int i) {
    int v = heap[i];
    for (;;) {
      size_t l = 2 * i + 1, r = 2 * i + 2, best = i;
      int bv = v;
      if (l < heap.size() && heap_lt(heap[l], bv)) { best = l; bv = heap[l]; }
      if (r < heap.size() && heap_lt(heap[r], bv)) { best = r; }
      if (best == (size_t)i) break;
      heap[i] = heap[best];
      heap_pos[heap[i]] = i;
      i = (int)best;
    }
    heap[i] = v;
    heap_pos[v] = i;
  }
  void heap_insert(int v) {
    if (heap_pos[v] >= 0) return;
    heap.push_back(v);
    heap_pos[v] = (int)heap.size() - 1;
    heap_up((int)heap.size() - 1);
  }
  int heap_pop() {
    int v = heap[0];
    heap_pos[v] = -1;
    heap[0] = heap.back();
    heap.pop_back();
    if (!heap.empty()) {
      heap_pos[heap[0]] = 0;
      heap_down(0);
    }
    return v;
  }

  void bump_var(int v) {
    act[v] += var_inc;
    if (act[v] > 1e100) {
      for (auto& a : act) a *= 1e-100;
      var_inc *= 1e-100;
    }
    if (heap_pos[v] >= 0) heap_up(heap_pos[v]);
  }

  // ---- assignment ----------------------------------------------------
  int decision_level() { return (int)trail_lim.size(); }

  // incremental solving: assumptions are re-asserted as the first
  // decisions after every restart; learned clauses are implied by the
  // clause database alone, so they stay valid across queries
  std::vector<int> assumptions;

  int8_t value_lit(int l) {
    int8_t a = assigns[lit_var(l)];
    if (a < 0) return -1;
    return lit_neg(l) ? (int8_t)(1 - a) : a;
  }

  bool enqueue(int l, Clause* from) {
    int8_t v = value_lit(l);
    if (v == 0) return false;  // conflict
    if (v == 1) return true;   // already
    int var = lit_var(l);
    assigns[var] = lit_neg(l) ? 0 : 1;
    phase[var] = assigns[var];
    reason[var] = from;
    level[var] = decision_level();
    trail.push_back(l);
    return true;
  }

  Clause* propagate() {
    while (qhead < trail.size()) {
      int p = trail[qhead++];
      propagations++;
      std::vector<Watcher>& ws = watches[lit_not(p)];
      size_t i = 0, j = 0;
      while (i < ws.size()) {
        Watcher w = ws[i++];
        if (value_lit(w.blocker) == 1) {  // satisfied via cached literal
          ws[j++] = w;
          continue;
        }
        if (w.is_bin) {
          // binary fast path: the blocker is the whole rest of the
          // clause — unit-propagate it without touching the watch
          // structure (Tseitin stores are ~2/3 binary clauses).
          // Analyze expects reason->lits[0] to be the propagated
          // literal; normalize before the clause becomes a reason.
          ws[j++] = w;
          if (w.c->lits[0] != w.blocker)
            std::swap(w.c->lits[0], w.c->lits[1]);
          if (!enqueue(w.blocker, w.c)) {
            while (i < ws.size()) ws[j++] = ws[i++];
            ws.resize(j);
            qhead = trail.size();
            return w.c;
          }
          continue;
        }
        // no deleted-clause check needed: reduce_db eagerly detaches a
        // clause from both watch lists before freeing it, so a watcher
        // can never reference a deleted clause
        Clause* c = w.c;
        auto& lits = c->lits;
        // make sure lits[1] is the false literal (not-p)
        if (lits[0] == lit_not(p)) std::swap(lits[0], lits[1]);
        if (value_lit(lits[0]) == 1) {  // satisfied
          ws[j++] = {c, lits[0], 0};
          continue;
        }
        // find new watch
        bool found = false;
        for (size_t k = 2; k < lits.size(); k++) {
          if (value_lit(lits[k]) != 0) {
            std::swap(lits[1], lits[k]);
            watches[lits[1]].push_back({c, lits[0], 0});
            found = true;
            break;
          }
        }
        if (found) continue;
        // unit or conflict
        ws[j++] = {c, lits[0], 0};
        if (!enqueue(lits[0], c)) {
          // conflict: restore remaining watches
          while (i < ws.size()) ws[j++] = ws[i++];
          ws.resize(j);
          qhead = trail.size();
          return c;
        }
      }
      ws.resize(j);
    }
    return nullptr;
  }

  void bump_clause(Clause* c) {
    c->activity += (float)cla_inc;
    if (c->activity > 1e20f) {
      for (auto* l : learnts) l->activity *= 1e-20f;
      cla_inc *= 1e-20;
    }
  }

  // 1UIP conflict analysis. `seen` is persistent and cleared via
  // `to_clear` — a full O(nvars) reset per conflict dominates analysis
  // cost at bit-blasted sizes (hundreds of thousands of vars).
  std::vector<char> seen;
  std::vector<int> to_clear;
  std::vector<int64_t> lbd_stamp;  // level -> conflict counter stamp
  int last_lbd = 0;  // LBD of the most recently analyzed clause
  std::vector<int> analyze_stack;  // DFS stack for lit_redundant

  uint32_t abstract_level(int v) { return 1u << (level[v] & 31); }

  // distinct decision levels among lits, via a stamped level array
  // (one linear pass, no sort). Callers pass distinct stamps so the
  // pre- and post-minimization counts within one conflict don't
  // collide: pre-pass stamps are negative, final stamps positive.
  int count_levels(const std::vector<int>& lits, int64_t stamp) {
    if (lbd_stamp.size() < (size_t)decision_level() + 1)
      lbd_stamp.resize(decision_level() + 1, -1);
    int n = 0;
    for (size_t k = 0; k < lits.size(); k++) {
      int lv = level[lit_var(lits[k])];
      if (lbd_stamp[lv] != stamp) {
        lbd_stamp[lv] = stamp;
        n++;
      }
    }
    return n;
  }

  // Is p implied by the still-seen learnt literals (+ level 0)? DFS
  // over reasons; marks proven-redundant vars seen (kept on success,
  // rolled back past `top` on failure). Terminates because each var
  // is pushed at most once (marked seen when pushed).
  bool lit_redundant(int p0, uint32_t abstract_levels) {
    analyze_stack.clear();
    analyze_stack.push_back(p0);
    size_t top = to_clear.size();
    while (!analyze_stack.empty()) {
      int p = analyze_stack.back();
      analyze_stack.pop_back();
      Clause* r = reason[lit_var(p)];
      for (size_t k = 1; k < r->lits.size(); k++) {
        int q = r->lits[k];
        int v = lit_var(q);
        if (seen[v] || level[v] == 0) continue;
        if (reason[v] == nullptr || !(abstract_level(v) & abstract_levels)) {
          for (size_t j = top; j < to_clear.size(); j++)
            seen[to_clear[j]] = 0;
          to_clear.resize(top);
          return false;
        }
        seen[v] = 1;
        to_clear.push_back(v);
        analyze_stack.push_back(q);
      }
    }
    return true;
  }
  void analyze(Clause* confl, std::vector<int>& out_learnt, int& out_btlevel) {
    out_learnt.clear();
    out_learnt.push_back(0);  // slot for asserting literal
    if ((int)seen.size() < nvars) seen.resize(nvars, 0);
    to_clear.clear();
    int counter = 0;
    int p = -1;
    size_t idx = trail.size();
    do {
      for (size_t k = (p == -1 ? 0 : 1); k < confl->lits.size(); k++) {
        int q = confl->lits[k];
        int v = lit_var(q);
        if (!seen[v] && level[v] > 0) {
          seen[v] = 1;
          to_clear.push_back(v);
          bump_var(v);
          if (level[v] >= decision_level())
            counter++;
          else
            out_learnt.push_back(q);
        }
      }
      if (confl->learnt) bump_clause(confl);
      // next literal on trail
      while (!seen[lit_var(trail[--idx])]) {}
      p = trail[idx];
      confl = reason[lit_var(p)];
      seen[lit_var(p)] = 0;
      counter--;
    } while (counter > 0);
    out_learnt[0] = lit_not(p);

    // deep conflict-clause minimization (MiniSat ccmin): a learnt
    // literal is dropped when every reason-DFS path from it bottoms
    // out in other learnt literals (seen) or level 0 — the abstract
    // level mask prunes branches that reach a decision level the
    // learnt clause does not contain. Shorter learnts propagate more
    // and earlier.
    size_t jj = 1;
    if (count_levels(out_learnt, -conflicts - 2) <= 6) {
      // deep mode pays on low-LBD clauses (glucose's gate: high
      // redundancy, bounded DFS); on scattered ones the reason-DFS
      // cost per conflict outruns the propagation it saves —
      // measured: ungated deep mode took a mul-heavy fixture from
      // 23.8s to 16.2s but pushed a branch-heavy one from
      // convergence back over its budget
      uint32_t abstract_levels = 0;
      for (size_t k = 1; k < out_learnt.size(); k++)
        abstract_levels |= abstract_level(lit_var(out_learnt[k]));
      for (size_t k = 1; k < out_learnt.size(); k++) {
        int v = lit_var(out_learnt[k]);
        if (reason[v] == nullptr ||
            !lit_redundant(out_learnt[k], abstract_levels))
          out_learnt[jj++] = out_learnt[k];
      }
    } else {
      // basic self-subsumption: drop a literal whose whole reason
      // clause is already inside the learnt set
      for (size_t k = 1; k < out_learnt.size(); k++) {
        int v = lit_var(out_learnt[k]);
        Clause* r = reason[v];
        bool redundant = false;
        if (r != nullptr) {
          redundant = true;
          for (size_t m = 1; m < r->lits.size(); m++) {
            int lv = lit_var(r->lits[m]);
            if (!seen[lv] && level[lv] > 0) {
              redundant = false;
              break;
            }
          }
        }
        if (!redundant) out_learnt[jj++] = out_learnt[k];
      }
    }
    out_learnt.resize(jj);
    for (int v : to_clear) seen[v] = 0;

    // literal block distance: distinct decision levels in the learnt
    // clause — glucose's predictor of clause usefulness
    last_lbd = count_levels(out_learnt, conflicts);

    // minimal backtrack level
    out_btlevel = 0;
    for (size_t k = 1; k < out_learnt.size(); k++)
      if (level[lit_var(out_learnt[k])] > out_btlevel)
        out_btlevel = level[lit_var(out_learnt[k])];
    // move a literal of btlevel to position 1 for watching
    if (out_learnt.size() > 1) {
      size_t maxi = 1;
      for (size_t k = 2; k < out_learnt.size(); k++)
        if (level[lit_var(out_learnt[k])] > level[lit_var(out_learnt[maxi])])
          maxi = k;
      std::swap(out_learnt[1], out_learnt[maxi]);
    }
  }

  void cancel_until(int lvl) {
    if (decision_level() <= lvl) return;
    for (int i = (int)trail.size() - 1; i >= trail_lim[lvl]; i--) {
      int v = lit_var(trail[i]);
      assigns[v] = -1;
      reason[v] = nullptr;
      heap_insert(v);
    }
    trail.resize(trail_lim[lvl]);
    trail_lim.resize(lvl);
    qhead = trail.size();
  }

  bool add_clause_internal(std::vector<int> lits, bool learnt) {
    if (!learnt) {
      // simplify: dedupe, tautology check, drop false lits at level 0
      std::vector<int> out;
      for (int l : lits) {
        int8_t v = value_lit(l);
        if (v == 1) return true;  // satisfied at level 0
        if (v == 0 && level[lit_var(l)] == 0) continue;
        bool dup = false, taut = false;
        for (int o : out) {
          if (o == l) dup = true;
          if (o == lit_not(l)) taut = true;
        }
        if (taut) return true;
        if (!dup) out.push_back(l);
      }
      lits = out;
    }
    if (lits.empty()) { ok = false; return false; }
    if (lits.size() == 1) {
      if (!enqueue(lits[0], nullptr)) { ok = false; return false; }
      return propagate() == nullptr ? true : (ok = false);
    }
    Clause* c = new Clause();
    c->lits = lits;
    c->learnt = learnt;
    (learnt ? learnts : clauses).push_back(c);
    int bin = lits.size() == 2 ? 1 : 0;
    watches[lits[0]].push_back({c, lits[1], bin});
    watches[lits[1]].push_back({c, lits[0], bin});
    return true;
  }

  void reduce_db() {
    // glucose-style: drop the half of learnt clauses with the worst
    // (highest) LBD, activity as tie-break; keep glue clauses
    // (lbd <= 2), binaries, and reason clauses
    std::vector<Clause*> sorted = learnts;
    std::sort(sorted.begin(), sorted.end(), [](Clause* a, Clause* b) {
      if (a->lbd != b->lbd) return a->lbd > b->lbd;
      return a->activity < b->activity;
    });
    size_t target = sorted.size() / 2;
    for (int v = 0; v < nvars; v++)
      if (assigns[v] >= 0 && reason[v] && reason[v]->learnt) reason[v]->keep_mark = 1;
    size_t removed = 0;
    for (auto* c : sorted) {
      if (removed >= target) break;
      if (c->lits.size() <= 2 || c->lbd <= 2 || c->keep_mark) {
        c->keep_mark = 0;
        continue;
      }
      c->deleted = true;
      removed++;
    }
    // compact learnt list; detach deleted clauses from their two watch
    // lists and free them — the solver is persistent across a whole
    // analysis run (SolverSession), so deferring frees to cdcl_delete
    // would leak linearly with total conflicts
    std::vector<Clause*> kept;
    for (auto* c : learnts) {
      if (c->deleted) {
        for (int widx = 0; widx < 2; widx++) {
          auto& ws = watches[c->lits[widx]];
          for (size_t k = 0; k < ws.size(); k++) {
            if (ws[k].c == c) {
              ws[k] = ws.back();
              ws.pop_back();
              break;
            }
          }
        }
        delete c;
        continue;
      }
      c->keep_mark = 0;
      kept.push_back(c);
    }
    learnts = kept;
  }

  static int64_t luby(int64_t i) {
    // Luby sequence: 1,1,2,1,1,2,4,1,1,2,1,1,2,4,8,... (0-indexed).
    // Find the smallest complete subsequence (length 2^seq - 1)
    // containing index i, then recurse into its position.
    int64_t size = 1, seq = 0;
    while (size < i + 1) { seq++; size = 2 * size + 1; }
    while (size - 1 != i) {
      size = (size - 1) >> 1;
      seq--;
      i = i % size;
    }
    return 1LL << seq;
  }

  // returns 1 sat, -1 unsat, 0 budget exhausted
  int solve(int64_t conflict_budget) {
    if (!ok) return -1;
    if (propagate() != nullptr) { ok = false; return -1; }
    int64_t restart_num = 0;
    int64_t limit_base = 100;
    std::vector<int> learnt_clause;
    int64_t next_reduce = 4000;
    for (;;) {
      int64_t restart_limit = limit_base * luby(restart_num);
      int64_t confl_this_restart = 0;
      for (;;) {
        Clause* confl = propagate();
        if (confl != nullptr) {
          conflicts++;
          confl_this_restart++;
          if (decision_level() == 0) return -1;  // toplevel conflict: UNSAT
          int btlevel;
          analyze(confl, learnt_clause, btlevel);
          cancel_until(btlevel);
          add_clause_internal(learnt_clause, true);
          if (!ok) return -1;  // unit learnt conflicted at level 0: UNSAT
          if (learnt_clause.size() > 1) {
            // clause watched; assert first literal
            learnts.back()->lbd = last_lbd;
            enqueue(learnt_clause[0], learnts.back());
          }
          var_inc *= 1.0 / 0.95;
          cla_inc *= 1.0 / 0.999;
          if (conflict_budget >= 0 && conflicts >= conflict_budget) return 0;
          if ((int64_t)learnts.size() >= next_reduce) {
            reduce_db();
            next_reduce += 2000;
          }
        } else {
          if (confl_this_restart >= restart_limit) {
            cancel_until(0);
            restart_num++;
            break;
          }
          // assert pending assumptions as decisions
          bool asserted = false;
          while (decision_level() < (int)assumptions.size()) {
            int p = assumptions[decision_level()];
            int av = p >> 1;
            int want = (p & 1) ? 0 : 1;
            if (assigns[av] >= 0) {
              if (assigns[av] != want) return -2;  // unsat under assumptions
              trail_lim.push_back((int)trail.size());  // vacuous level
              continue;
            }
            trail_lim.push_back((int)trail.size());
            enqueue(p, nullptr);
            asserted = true;
            break;
          }
          if (asserted) continue;  // propagate the assumption

          // decide
          int v = -1;
          while (!heap.empty()) {
            int cand = heap_pop();
            if (assigns[cand] < 0) { v = cand; break; }
          }
          if (v < 0) return 1;  // all assigned: SAT
          trail_lim.push_back((int)trail.size());
          enqueue(mklit(v, phase[v] == 0), nullptr);
        }
      }
    }
  }
};

}  // namespace

extern "C" {

void* cdcl_new() { return new Solver(); }

void cdcl_delete(void* s) { delete (Solver*)s; }

int cdcl_new_var(void* s) { return ((Solver*)s)->new_var(); }

// lits: DIMACS style (+-(var+1)), n entries. Returns 0 if formula
// became trivially unsat.
int cdcl_add_clause(void* s, const int* lits, int n) {
  Solver* solver = (Solver*)s;
  if (!solver->ok) return 0;
  std::vector<int> internal(n);
  for (int i = 0; i < n; i++) {
    int l = lits[i];
    int var = std::abs(l) - 1;
    internal[i] = mklit(var, l < 0);
  }
  solver->add_clause_internal(internal, false);
  return solver->ok ? 1 : 0;
}

// 1 = SAT, -1 = UNSAT, 0 = conflict budget exhausted (unknown)
int cdcl_solve(void* s, int64_t conflict_budget) {
  return ((Solver*)s)->solve(conflict_budget);
}

// value of var in the found model (0/1); -1 if unassigned
int cdcl_value(void* s, int var) {
  Solver* solver = (Solver*)s;
  if (var >= solver->nvars) return -1;
  return solver->assigns[var];
}

int64_t cdcl_conflicts(void* s) { return ((Solver*)s)->conflicts; }

// Create variables until the solver has at least n.
void cdcl_ensure_vars(void* s, int n) {
  Solver* solver = (Solver*)s;
  while (solver->nvars < n) solver->new_var();
}

// Bulk clause load: lits is a 0-separated stream of DIMACS literals
// ("a b 0 c d e 0 ..."), n entries total. One call replaces thousands
// of per-clause FFI crossings. Returns 0 if the formula became
// trivially unsat.
int cdcl_add_clauses_flat(void* s, const int* lits, long long n) {
  Solver* solver = (Solver*)s;
  solver->cancel_until(0);  // clause additions must happen at level 0
  std::vector<int> internal;
  internal.reserve(16);
  for (long long i = 0; i < n; i++) {
    int l = lits[i];
    if (l == 0) {
      if (!solver->ok) return 0;
      solver->add_clause_internal(internal, false);
      internal.clear();
      if (!solver->ok) return 0;
    } else {
      int var = std::abs(l) - 1;
      internal.push_back(mklit(var, l < 0));
    }
  }
  return solver->ok ? 1 : 0;
}

// Solve under assumptions (0-terminated not required; n literals).
// Returns 1 SAT, -1 UNSAT (global or under these assumptions),
// 0 budget exhausted. conflict_budget is an absolute conflict count
// (compare against cdcl_conflicts), so chunked callers keep learned
// progress across calls.
int cdcl_solve_assuming(void* s, int64_t conflict_budget, const int* lits,
                        int n) {
  Solver* solver = (Solver*)s;
  if (!solver->ok) return -1;
  solver->cancel_until(0);
  solver->assumptions.clear();
  for (int i = 0; i < n; i++) {
    int l = lits[i];
    solver->assumptions.push_back(mklit(std::abs(l) - 1, l < 0));
  }
  int r = solver->solve(conflict_budget);
  if (r == -2) {
    solver->cancel_until(0);
    return -1;
  }
  if (r != 1) solver->cancel_until(0);
  return r;
}

// Bulk model extraction: out[v] = 1/0 for v in [0, n); unassigned
// variables read as 0 (model completion).
void cdcl_model_bits(void* s, unsigned char* out, int n) {
  Solver* solver = (Solver*)s;
  for (int v = 0; v < n; v++) {
    out[v] = (v < solver->nvars && solver->assigns[v] == 1) ? 1 : 0;
  }
}

}  // extern "C"
