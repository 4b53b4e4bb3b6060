// Window projection: CIGAR walk -> variant calls -> allele matrices.
//
// The capability equivalent of the reference's per-window native pipeline
// (impg query -> odgi build/sort/view -> povu gfa2vcf, run_tajd.sh:126-148,
// and impg similarity, run_pica2_impg.sh:162-168): a window's variation is
// derived directly from the PAF alignments as per-haplotype variant calls
// against the reference; the haplotype-by-site matrix then feeds every device
// statistic (identity, pi, S, AFS) without further native calls.
//
// Design: extraction is RANGE-based.  extract_windows() walks each PAF
// record ONCE over the union span of a sorted window batch and bins calls
// into windows as it goes (deletions clipped at window bounds, insertion /
// coverage boundary rules below) — the reference re-runs its native
// pipeline per window (run_pica2_impg.sh:126-192), which re-walks every
// whole-chromosome alignment O(windows) times.  Query bases are touched
// only at variant sites via an mmap'd O(1) view when the store allows it
// (plain/gzip FASTA); BGZF falls back to one materialised slice per record
// per range.  extract() is the one-window special case.
#include "extract.h"

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <thread>
#include <chrono>
#include <cstdio>

namespace impop {

namespace {

// ASCII uppercase lookup — std::toupper is a per-call locale lookup and
// dominated SNP emission profiles (it runs per touched base).
struct UpperTable {
  char t[256];
  UpperTable() {
    for (int i = 0; i < 256; ++i) t[i] = static_cast<char>(i);
    for (int i = 'a'; i <= 'z'; ++i) t[i] = static_cast<char>(i - 32);
  }
};
const UpperTable kUpper;
inline char upper(char c) { return kUpper.t[static_cast<unsigned char>(c)]; }

// seek() lands up to one checkpoint stride before the requested position;
// pad in-range op estimates by that much.
constexpr size_t kCkptStrideSlack = 2 * 64;

char comp(char c) {
  switch (c) {
    case 'A': return 'T';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'T': return 'A';
    case 'a': return 't';
    case 'c': return 'g';
    case 'g': return 'c';
    case 't': return 'a';
    default: return 'N';
  }
}

std::string revcomp(const std::string& s) {
  std::string out(s.rbegin(), s.rend());
  for (char& c : out) c = comp(c);
  return out;
}

// 24-byte POD: allele bytes live in a per-walk char pool (offsets below).
// std::string members cost two heap allocations per emitted variant and
// pointer-chasing compares — at ~20k emissions/window that dominated the
// batch-extraction profile.
struct Variant {
  int64_t pos;       // target position (0-based)
  uint32_t ref_off;  // pool offset of reference allele (len 0 = insertion)
  uint32_t alt_off;  // pool offset of alternate allele (len 0 = deletion)
  uint32_t ref_len;
  uint32_t alt_len;
};

inline int cmp_span(const char* a, uint32_t alen, const char* b,
                    uint32_t blen) {
  const uint32_t m = alen < blen ? alen : blen;
  if (m) {
    const int c = std::memcmp(a, b, m);
    if (c) return c;
  }
  return (alen > blen) - (alen < blen);
}

// Lexicographic (pos, ref, alt) — the same total order the previous
// std::string representation induced; column order (and thus site_keys
// output order) is pinned by tests against the Python oracle.
inline int cmp_variant(const Variant& a, const char* pa, const Variant& b,
                       const char* pb) {
  if (a.pos != b.pos) return a.pos < b.pos ? -1 : 1;
  const int c =
      cmp_span(pa + a.ref_off, a.ref_len, pb + b.ref_off, b.ref_len);
  if (c) return c;
  return cmp_span(pa + a.alt_off, a.alt_len, pb + b.alt_off, b.alt_len);
}

// One record's window-binned calls over a scan range.
struct RecWalk {
  const PafRecord* rec = nullptr;
  std::string row_name;
  int64_t t_final = 0;            // final target pos reached by the walk
  std::string pool;               // allele bytes (Variant offsets index here)
  std::vector<Variant> variants;  // window-clipped; (win, variant)-sorted
  std::vector<int32_t> win_of;    // parallel to variants, non-decreasing
  // variant index range per window: (win, begin); end = next begin
  std::vector<std::pair<int32_t, int32_t>> spans;

  std::pair<int32_t, int32_t> range_in(int32_t w) const {
    // spans is sorted by win; binary search
    size_t lo = 0, hi = spans.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (spans[mid].first < w) lo = mid + 1; else hi = mid;
    }
    if (lo == spans.size() || spans[lo].first != w) return {0, 0};
    const int32_t begin = spans[lo].second;
    const int32_t end = lo + 1 < spans.size()
                            ? spans[lo + 1].second
                            : static_cast<int32_t>(variants.size());
    return {begin, end};
  }
};

// Walk one record over [lo, hi), binning calls into the sorted,
// non-overlapping windows (wstart[i], wend[i]).
//
// Per-window semantics (must match the one-window case exactly; pinned by
// tests against the Python oracle extractor):
//  - base-anchored variants (M/X resolution, deletions) belong to the
//    window with wstart <= pos < wend; deletions crossing a window bound
//    are clipped per window (key pos = clip start, ref = clipped bases);
//  - insertions sit BETWEEN bases: window with wstart < pos <= wend;
//  - coverage is the record's walked target span clipped per window.
void walk_range(const PafRecord* rec, const FastaReader& fasta,
                const std::string& tseq, int64_t lo, int64_t hi,
                const std::vector<int64_t>& wstart,
                const std::vector<int64_t>& wend, RecWalk* out) {
  out->rec = rec;
  out->row_name = rec->query_name + ":" + std::to_string(rec->query_start) +
                  "-" + std::to_string(rec->query_end);

  auto target_base = [&](int64_t pos) -> char {
    const int64_t off = pos - lo;
    if (off < 0 || off >= static_cast<int64_t>(tseq.size())) return 'N';
    return upper(tseq[static_cast<size_t>(off)]);
  };

  int64_t tpos = rec->target_start;
  int64_t qi = 0;
  const size_t first_op = rec->seek(lo, &tpos, &qi);

  // one allocation up front: ~one variant per non-match op, ~2 pool bytes
  // each (SNPs dominate).  Estimate ops IN RANGE via a checkpoint seek to
  // `hi` — reserving to the record's end overallocated ~5 MB per record
  // per chunk on chromosome-scale scans (most of the CIGAR lies past the
  // chunk), which dominated the in-scan extraction profile.
  int64_t est_t = 0, est_q = 0;
  const size_t hi_op = rec->seek(hi, &est_t, &est_q);
  const size_t est =
      std::max<size_t>(hi_op, first_op) - first_op + kCkptStrideSlack;
  out->variants.reserve(est);
  out->win_of.reserve(est);
  out->pool.reserve(2 * est + 16);

  // Query access: O(1) view when the store supports it; otherwise one
  // materialised slice covering the range's query extent (the extent's end
  // comes from a checkpoint seek to `hi` plus a short tail walk).
  const bool have_q = fasta.has(rec->query_name);
  const FastaReader::BaseView view =
      have_q ? fasta.base_view(rec->query_name) : FastaReader::BaseView();
  std::string qslice;
  const int64_t q_lo = qi;
  if (have_q && !view.valid()) {
    int64_t t2 = tpos, q2 = qi;
    size_t oi = rec->seek(hi, &t2, &q2);
    for (; oi < rec->cigar.size(); ++oi) {
      const CigarOp& op = rec->cigar[oi];
      if (t2 >= hi && op.op != 'I') break;
      switch (op.op) {
        case '=': case 'M': case 'X': t2 += op.len; q2 += op.len; break;
        case 'I': case 'S': q2 += op.len; break;
        case 'D': case 'N': t2 += op.len; break;
        case 'H': break;
        default: t2 += op.len; q2 += op.len; break;
      }
    }
    const int64_t q_hi = q2;
    if (q_hi > q_lo) {
      if (!rec->reverse) {
        qslice = fasta.fetch(rec->query_name, rec->query_start + q_lo,
                             rec->query_start + q_hi);
      } else {
        // qi indexes the reverse complement of [query_start, query_end);
        // RC index qi maps to original position query_end - 1 - qi
        qslice = revcomp(fasta.fetch(rec->query_name, rec->query_end - q_hi,
                                     rec->query_end - q_lo));
      }
    }
  }
  // walks touch query bases in monotone order (ascending for forward
  // records, descending original coordinates for reverse ones), so a
  // divisionless cursor replaces BaseView::at's two divisions per base
  FastaReader::BaseView::Cursor qcur(view);
  auto query_base = [&](int64_t q) -> char {
    if (!have_q) return 'N';
    if (view.valid()) {
      if (!rec->reverse) {
        return upper(qcur.get(rec->query_start + q));
      }
      return comp(upper(qcur.get(rec->query_end - 1 - q)));
    }
    const int64_t off = q - q_lo;
    if (off < 0 || off >= static_cast<int64_t>(qslice.size())) return 'N';
    return upper(qslice[static_cast<size_t>(off)]);
  };

  // Window cursors: walk positions are non-decreasing, so each advances
  // monotonically.  Separate cursors because the insertion rule (wend >=
  // pos) lags the base rule (wend > pos) by one window at shared bounds.
  const size_t n_win = wstart.size();
  size_t cb = 0;
  auto win_at_base = [&](int64_t p) -> int32_t {
    while (cb < n_win && wend[cb] <= p) ++cb;
    if (cb < n_win && wstart[cb] <= p) return static_cast<int32_t>(cb);
    return -1;
  };
  size_t ci = 0;
  auto win_at_ins = [&](int64_t p) -> int32_t {
    while (ci < n_win && wend[ci] < p) ++ci;
    if (ci < n_win && wstart[ci] < p) return static_cast<int32_t>(ci);
    return -1;
  };
  auto emit_snp = [&](int32_t w, int64_t pos, char ref_c, char alt_c) {
    const uint32_t off = static_cast<uint32_t>(out->pool.size());
    out->pool.push_back(ref_c);
    out->pool.push_back(alt_c);
    out->win_of.push_back(w);
    out->variants.push_back({pos, off, off + 1, 1, 1});
  };

  for (size_t oi = first_op; oi < rec->cigar.size(); ++oi) {
    const CigarOp& op = rec->cigar[oi];
    if (tpos >= hi && op.op != 'I') break;
    switch (op.op) {
      case '=':
        tpos += op.len;
        qi += op.len;
        break;
      case 'M': {
        // resolve match-or-mismatch against the sequences; missing query
        // degrades M to "no variant"
        for (int64_t k = 0; k < op.len; ++k) {
          const int64_t p = tpos + k;
          if (p >= lo && p < hi && have_q) {
            const int32_t w = win_at_base(p);
            if (w >= 0) {
              const char tb = target_base(p);
              const char qb = query_base(qi + k);
              if (tb != qb && tb != 'N' && qb != 'N') {
                emit_snp(w, p, tb, qb);
              }
            }
          }
        }
        tpos += op.len;
        qi += op.len;
        break;
      }
      case 'X': {
        for (int64_t k = 0; k < op.len; ++k) {
          const int64_t p = tpos + k;
          if (p >= lo && p < hi) {
            const int32_t w = win_at_base(p);
            if (w >= 0) {
              emit_snp(w, p, target_base(p), query_base(qi + k));
            }
          }
        }
        tpos += op.len;
        qi += op.len;
        break;
      }
      case 'I': {
        const int32_t w = win_at_ins(tpos);
        if (w >= 0 && tpos <= hi) {
          std::string& pool = out->pool;
          const uint32_t aoff = static_cast<uint32_t>(pool.size());
          if (have_q && view.valid()) {
            for (int64_t k = 0; k < op.len; ++k) {
              pool.push_back(query_base(qi + k));
            }
          } else if (have_q) {
            const int64_t off = qi - q_lo;
            if (off >= 0 &&
                off + op.len <= static_cast<int64_t>(qslice.size())) {
              for (int64_t k = 0; k < op.len; ++k) {
                pool.push_back(upper(qslice[static_cast<size_t>(off + k)]));
              }
            } else {
              pool += "<INS" + std::to_string(op.len) + ">";
            }
          } else {
            pool += "<INS" + std::to_string(op.len) + ">";
          }
          const uint32_t alen = static_cast<uint32_t>(pool.size()) - aoff;
          out->win_of.push_back(w);
          out->variants.push_back({tpos, aoff, aoff, 0, alen});
        }
        qi += op.len;
        break;
      }
      case 'D':
      case 'N': {
        if (op.op == 'D') {
          const int64_t dlo = std::max(tpos, lo);
          const int64_t dhi = std::min(tpos + op.len, hi);
          size_t cw = cb;  // local scan; cb windows are already past dlo
          while (cw < n_win && wend[cw] <= dlo) ++cw;
          for (; cw < n_win && wstart[cw] < dhi; ++cw) {
            const int64_t ds = std::max(dlo, wstart[cw]);
            const int64_t de = std::min(dhi, wend[cw]);
            if (ds < de) {
              std::string& pool = out->pool;
              const uint32_t roff = static_cast<uint32_t>(pool.size());
              for (int64_t p = ds; p < de; ++p) {
                pool.push_back(target_base(p));
              }
              out->win_of.push_back(static_cast<int32_t>(cw));
              out->variants.push_back(
                  {ds, roff, roff, static_cast<uint32_t>(de - ds), 0});
            }
          }
        }
        tpos += op.len;
        break;
      }
      case 'S':
        qi += op.len;
        break;
      case 'H':
        break;
      default:
        // unknown op: assume it consumes both (safest for M-like ops)
        tpos += op.len;
        qi += op.len;
        break;
    }
  }
  out->t_final = tpos;

  // Emission is (win, variant)-sorted by construction for well-formed
  // CIGARs; guard with an index sort + dedup if an exotic one violates it.
  const char* pool = out->pool.data();
  bool sorted = true;
  for (size_t i = 1; i < out->variants.size(); ++i) {
    if (out->win_of[i - 1] > out->win_of[i] ||
        (out->win_of[i - 1] == out->win_of[i] &&
         cmp_variant(out->variants[i], pool, out->variants[i - 1], pool) <
             0)) {
      sorted = false;
      break;
    }
  }
  if (!sorted) {
    std::vector<size_t> order(out->variants.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](size_t a, size_t b) {
      if (out->win_of[a] != out->win_of[b])
        return out->win_of[a] < out->win_of[b];
      return cmp_variant(out->variants[a], pool, out->variants[b], pool) < 0;
    });
    std::vector<Variant> v2;
    std::vector<int32_t> w2;
    v2.reserve(order.size());
    w2.reserve(order.size());
    for (size_t i : order) {
      v2.push_back(out->variants[i]);
      w2.push_back(out->win_of[i]);
    }
    out->variants = std::move(v2);
    out->win_of = std::move(w2);
  }
  // dedup adjacent duplicates (same window, same variant)
  size_t keep = 0;
  for (size_t i = 0; i < out->variants.size(); ++i) {
    if (keep > 0 && out->win_of[keep - 1] == out->win_of[i] &&
        cmp_variant(out->variants[keep - 1], pool, out->variants[i], pool) ==
            0) {
      continue;
    }
    if (keep != i) {
      out->variants[keep] = out->variants[i];
      out->win_of[keep] = out->win_of[i];
    }
    ++keep;
  }
  out->variants.resize(keep);
  out->win_of.resize(keep);

  // per-window index spans
  for (size_t i = 0; i < out->win_of.size(); ++i) {
    if (out->spans.empty() || out->spans.back().first != out->win_of[i]) {
      out->spans.emplace_back(out->win_of[i], static_cast<int32_t>(i));
    }
  }
}

// A row of one window's matrix before filling: name + clipped coverage +
// the contributing records' variant ranges (>1 when same-named records are
// merged, matching the one-window map-by-name semantics).
struct RowItem {
  const std::string* name;
  int64_t cs, ce;  // covered target span within the window (cs > ce: none)
  // (walk, begin, end) variant ranges
  std::vector<std::tuple<const RecWalk*, int32_t, int32_t>> parts;
};

// Scratch reused across a thread's windows: position-bucket chains over the
// window span.  The two-pointer union merge is O(rows x union) SiteRef
// copies + cmp_variant calls per window (measured 52M compares per 600
// HPRC-shaped windows — the build-stage hotspot); bucketing by (pos - ws)
// makes union construction and cell fill O(emissions + span) with tiny
// constants.  Chains per position are 1-2 long (few distinct alleles per
// site), kept (ref, alt)-sorted so column order stays the lexicographic
// (pos, ref, alt) the tests pin.
struct BuildScratch {
  struct Node {
    const Variant* v;
    const char* pool;
    int32_t next;
  };
  std::vector<int32_t> head;    // bucket -> first node index (-1 = empty)
  std::vector<Node> nodes;      // union variants in first-seen order
  std::vector<int32_t> emis;    // node index per emission, row-major
  std::vector<int32_t> node_col;  // node index -> final column
};

constexpr int64_t kMaxBucketSpan = int64_t(1) << 22;  // fall back past 4 Mb

WindowMatrix build_window(const std::vector<const RecWalk*>& by_name,
                          const std::string& target, int64_t ws, int64_t we,
                          int32_t w) {
  // rows: records whose PAF target span overlaps the window (the
  // PafIndex::overlapping predicate), merged by row name
  std::vector<RowItem> rows;
  rows.reserve(by_name.size() + 1);
  for (const RecWalk* rw : by_name) {
    if (rw->rec->target_start >= we || rw->rec->target_end <= ws) continue;
    const int64_t cs = std::max(ws, rw->rec->target_start);
    const int64_t ce = std::min(we, rw->t_final);
    const auto [vb, vend] = rw->range_in(w);
    if (!rows.empty() && *rows.back().name == rw->row_name) {
      RowItem& r = rows.back();  // same-name merge: span union
      r.cs = std::min(r.cs, cs);
      r.ce = std::max(r.ce, ce);
      if (vend > vb) r.parts.emplace_back(rw, vb, vend);
    } else {
      rows.push_back({&rw->row_name, cs, ce, {}});
      if (vend > vb) rows.back().parts.emplace_back(rw, vb, vend);
    }
  }
  // Reference row: covers the whole window, no variants (impg similarity
  // includes the reference sequence among the groups).
  const std::string ref_name =
      target + ":" + std::to_string(ws) + "-" + std::to_string(we);
  {
    auto it = std::lower_bound(
        rows.begin(), rows.end(), ref_name,
        [](const RowItem& r, const std::string& n) { return *r.name < n; });
    rows.insert(it, RowItem{&ref_name, ws, we, {}});
  }

  // Site axis: union of the rows' variants.  Fast path: bucket variants by
  // (pos - ws) into per-position chains (see BuildScratch) — O(emissions +
  // span).  Fallback for giant windows: two-pointer merges (each record's
  // window slice is already sorted+unique).
  struct SiteRef {
    const Variant* v;
    const char* pool;
  };
  std::vector<SiteRef> site_union;
  const int64_t span = we - ws;
  bool bucketed = span <= kMaxBucketSpan;
  thread_local BuildScratch scratch;
  BuildScratch& S = scratch;
  if (bucketed) {
    // insertion-rule positions reach `we` (pos - ws == span), hence span+1
    S.head.assign(static_cast<size_t>(span) + 1, -1);
    S.nodes.clear();
    S.emis.clear();
    auto cmp_ra = [](const BuildScratch::Node& n, const Variant& v,
                     const char* pool) {
      const int c = cmp_span(n.pool + n.v->ref_off, n.v->ref_len,
                             pool + v.ref_off, v.ref_len);
      if (c) return c;
      return cmp_span(n.pool + n.v->alt_off, n.v->alt_len,
                      pool + v.alt_off, v.alt_len);
    };
    for (const RowItem& r : rows) {
      for (const auto& [rw, vb, vend] : r.parts) {
        const char* pool = rw->pool.data();
        for (int32_t i = vb; bucketed && i < vend; ++i) {
          const Variant& v = rw->variants[static_cast<size_t>(i)];
          const int64_t off = v.pos - ws;
          if (off < 0 || off > span) {  // defensive: shouldn't happen
            bucketed = false;
            break;
          }
          // chain insert keeping (ref, alt) sort order (pos is equal
          // within a bucket); chains are 1-2 long in practice
          int32_t cur = S.head[static_cast<size_t>(off)];
          int32_t prev = -1, node_idx = -1;
          while (cur >= 0) {
            const int c = cmp_ra(S.nodes[static_cast<size_t>(cur)], v, pool);
            if (c == 0) {
              node_idx = cur;
              break;
            }
            if (c > 0) break;  // insert before `cur`
            prev = cur;
            cur = S.nodes[static_cast<size_t>(cur)].next;
          }
          if (node_idx < 0) {
            node_idx = static_cast<int32_t>(S.nodes.size());
            S.nodes.push_back({&v, pool, cur});
            if (prev < 0) {
              S.head[static_cast<size_t>(off)] = node_idx;
            } else {
              S.nodes[static_cast<size_t>(prev)].next = node_idx;
            }
          }
          S.emis.push_back(node_idx);
        }
      }
    }
  }
  if (bucketed) {
    // column order: ascending bucket (pos), then chain order (ref, alt) —
    // the same lexicographic total order the merge path produces
    S.node_col.assign(S.nodes.size(), 0);
    site_union.reserve(S.nodes.size());
    for (size_t off = 0; off < S.head.size(); ++off) {
      for (int32_t cur = S.head[off]; cur >= 0;
           cur = S.nodes[static_cast<size_t>(cur)].next) {
        S.node_col[static_cast<size_t>(cur)] =
            static_cast<int32_t>(site_union.size());
        site_union.push_back({S.nodes[static_cast<size_t>(cur)].v,
                              S.nodes[static_cast<size_t>(cur)].pool});
      }
    }
  } else {
    site_union.clear();
    std::vector<SiteRef> merged;
    for (const RowItem& r : rows) {
      for (const auto& [rw, vb, vend] : r.parts) {
        const char* pool = rw->pool.data();
        const Variant* s_it = rw->variants.data() + vb;
        const Variant* s_end = rw->variants.data() + vend;
        merged.clear();
        merged.reserve(site_union.size() + static_cast<size_t>(vend - vb));
        auto u_it = site_union.begin();
        while (u_it != site_union.end() && s_it != s_end) {
          const int c = cmp_variant(*u_it->v, u_it->pool, *s_it, pool);
          if (c < 0) {
            merged.push_back(*u_it++);
          } else if (c > 0) {
            merged.push_back({s_it++, pool});
          } else {
            merged.push_back(*u_it++);
            ++s_it;
          }
        }
        merged.insert(merged.end(), u_it, site_union.end());
        for (; s_it != s_end; ++s_it) merged.push_back({s_it, pool});
        site_union.swap(merged);
      }
    }
  }

  WindowMatrix wm;
  wm.n = static_cast<int64_t>(rows.size());
  wm.s = static_cast<int64_t>(site_union.size());
  wm.names.reserve(rows.size());
  wm.site_keys.reserve(site_union.size());
  wm.site_pos.reserve(site_union.size());
  for (const SiteRef& sr : site_union) {
    std::string key = std::to_string(sr.v->pos);
    key += ':';
    key.append(sr.pool + sr.v->ref_off, sr.v->ref_len);
    key += '>';
    key.append(sr.pool + sr.v->alt_off, sr.v->alt_len);
    wm.site_keys.push_back(std::move(key));
    wm.site_pos.push_back(sr.v->pos);
  }
  wm.geno.assign(
      static_cast<size_t>(wm.n) * static_cast<size_t>(std::max<int64_t>(wm.s, 1)),
      -1);

  const int64_t s_count = wm.s;
  auto pos_lower = [&](int64_t pos) {
    return std::lower_bound(wm.site_pos.begin(), wm.site_pos.end(), pos) -
           wm.site_pos.begin();
  };
  auto pos_upper = [&](int64_t pos) {
    return std::upper_bound(wm.site_pos.begin(), wm.site_pos.end(), pos) -
           wm.site_pos.begin();
  };

  int64_t row = 0;
  size_t e = 0;  // bucketed mode: emission cursor (same iteration order
                 // as the union pass, so S.emis lines up exactly)
  for (const RowItem& r : rows) {
    wm.names.push_back(*r.name);
    int8_t* g = wm.geno.data() +
                static_cast<size_t>(row) *
                    static_cast<size_t>(std::max<int64_t>(s_count, 1));
    // Column coverage: insertion columns (empty ref) sit *between* bases,
    // so a haplotype covers them iff cs < pos <= ce; base-anchored variants
    // use cs <= pos < ce.  Both rules agree on the open interval (cs, ce),
    // so coverage is one contiguous fill plus the two boundary positions.
    if (r.cs <= r.ce && s_count > 0) {
      const int64_t lo_c = pos_upper(r.cs);
      const int64_t hi_c = pos_lower(r.ce);
      if (hi_c > lo_c) std::memset(g + lo_c, 0, static_cast<size_t>(hi_c - lo_c));
      for (int64_t c = pos_lower(r.cs);
           c < s_count && wm.site_pos[static_cast<size_t>(c)] == r.cs; ++c) {
        if (site_union[static_cast<size_t>(c)].v->ref_len != 0) g[c] = 0;
      }
      for (int64_t c = pos_lower(r.ce);
           c < s_count && wm.site_pos[static_cast<size_t>(c)] == r.ce; ++c) {
        if (site_union[static_cast<size_t>(c)].v->ref_len == 0) g[c] = 0;
      }
    }
    // variant cells.  Bucketed: each emission already knows its union node
    // (recorded in pass 1), so the fill is one array lookup per cell.
    // Fallback: the row's slice and the union share one sort order, so a
    // two-pointer co-walk finds each column in O(union + slice).
    if (bucketed) {
      for (const auto& [rw, vb, vend] : r.parts) {
        (void)rw;
        for (int32_t i = vb; i < vend; ++i) {
          g[S.node_col[static_cast<size_t>(S.emis[e++])]] = 1;
        }
      }
    } else {
      for (const auto& [rw, vb, vend] : r.parts) {
        const char* pool = rw->pool.data();
        size_t u = 0;
        for (int32_t i = vb; i < vend; ++i) {
          const Variant& v = rw->variants[static_cast<size_t>(i)];
          while (u < site_union.size() &&
                 cmp_variant(*site_union[u].v, site_union[u].pool, v, pool) <
                     0) {
            ++u;
          }
          g[u] = 1;
        }
      }
    }
    ++row;
  }
  return wm;
}

// Run fn(i) for i in [0, count) on up to `threads` workers.
template <typename Fn>
void parallel_for(int threads, size_t count, Fn fn) {
  threads = static_cast<int>(
      std::min<size_t>(static_cast<size_t>(std::max(threads, 1)), count));
  if (threads <= 1) {
    for (size_t i = 0; i < count; ++i) fn(i);
    return;
  }
  std::atomic<size_t> next{0};
  auto worker = [&]() {
    for (;;) {
      const size_t i = next.fetch_add(1);
      if (i >= count) break;
      fn(i);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(threads));
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

int resolve_threads(int threads) {
  if (threads > 0) return threads;
  if (const char* env = std::getenv("IMPOP_EXTRACT_THREADS")) {
    return std::max(1, std::atoi(env));
  }
  return static_cast<int>(std::max(1u, std::thread::hardware_concurrency()));
}

Extractor::Extractor(const std::string& paf_path, const std::string& fasta_path)
    : paf_(paf_path), fasta_(fasta_path) {}

std::vector<WindowMatrix> Extractor::extract_windows(
    const std::string& target,
    const std::vector<std::pair<int64_t, int64_t>>& wins, int threads) const {
  if (wins.empty()) return {};
  for (size_t i = 0; i < wins.size(); ++i) {
    if (wins[i].second <= wins[i].first) {
      throw std::runtime_error("empty window");
    }
    if (i > 0 && wins[i].first < wins[i - 1].second) {
      throw std::runtime_error(
          "extract_windows requires sorted, non-overlapping windows");
    }
  }
  const int64_t lo = wins.front().first;
  const int64_t hi = wins.back().second;
  const int n_threads = resolve_threads(threads);

  const std::string tseq =
      fasta_.has(target) ? fasta_.fetch(target, lo, hi) : std::string();

  std::vector<const PafRecord*> recs = paf_.overlapping(target, lo, hi);
  recs.erase(std::remove_if(recs.begin(), recs.end(),
                            [](const PafRecord* r) {
                              return r->cigar.empty();  // need cg:Z
                            }),
             recs.end());

  std::vector<int64_t> wstart(wins.size()), wend(wins.size());
  for (size_t i = 0; i < wins.size(); ++i) {
    wstart[i] = wins[i].first;
    wend[i] = wins[i].second;
  }

  // Stage 1: one walk per record (parallel over records).
  const bool timing = std::getenv("IMPOP_EXTRACT_TIMING") != nullptr;
  const auto t0 = std::chrono::steady_clock::now();
  std::vector<RecWalk> walks(recs.size());
  parallel_for(n_threads, recs.size(), [&](size_t i) {
    walk_range(recs[i], fasta_, tseq, lo, hi, wstart, wend, &walks[i]);
  });
  const auto t1 = std::chrono::steady_clock::now();

  // Row order = sorted row names (the one-window case used a name-keyed
  // map); stable so same-named records merge deterministically.
  std::vector<const RecWalk*> by_name;
  by_name.reserve(walks.size());
  for (const RecWalk& rw : walks) by_name.push_back(&rw);
  std::stable_sort(by_name.begin(), by_name.end(),
                   [](const RecWalk* a, const RecWalk* b) {
                     return a->row_name < b->row_name;
                   });

  // Stage 2: per-window matrix builds (parallel over windows).
  std::vector<WindowMatrix> out(wins.size());
  parallel_for(n_threads, wins.size(), [&](size_t w) {
    out[w] = build_window(by_name, target, wstart[w], wend[w],
                          static_cast<int32_t>(w));
  });
  if (timing) {
    const auto t2 = std::chrono::steady_clock::now();
    const auto ms = [](auto a, auto b) {
      return std::chrono::duration<double, std::milli>(b - a).count();
    };
    std::fprintf(stderr,
                 "[extract] walks=%zu %.1f ms, builds=%zu %.1f ms\n",
                 recs.size(), ms(t0, t1), wins.size(), ms(t1, t2));
  }
  return out;
}

WindowMatrix Extractor::extract(const std::string& target, int64_t start,
                                int64_t end, int inner_threads) const {
  auto v = extract_windows(target, {{start, end}}, inner_threads);
  return std::move(v.front());
}

}  // namespace impop
