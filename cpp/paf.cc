// PAF parsing (plain or gzip) with cg:Z CIGAR, indexed by target interval.
#include "extract.h"

#include <algorithm>
#include <cstring>
#include <stdexcept>
#include <zlib.h>
#include <atomic>
#include <thread>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace impop {

static std::vector<CigarOp> parse_cigar(const char* s, const char* end) {
  std::vector<CigarOp> ops;
  // ~2 chars per op lower bound; one reservation instead of log2(n) grows
  ops.reserve(static_cast<size_t>(end - s) / 3 + 4);
  int64_t len = 0;
  for (; s != end; ++s) {
    char c = *s;
    if (c >= '0' && c <= '9') {
      len = len * 10 + (c - '0');
    } else {
      ops.push_back({c, len});
      len = 0;
    }
  }
  return ops;
}

// Parse one PAF line from a raw byte span (no per-column allocations —
// names copy out, integers parse in place, the CIGAR parses straight off
// the buffer).  Works for both the gz line path and the mmap path.
static bool parse_line(const char* b, const char* e, PafRecord* rec) {
  const char* col[13];  // starts of the first 13 columns (12 + first tag)
  const char* p = b;
  int nc = 0;
  col[nc++] = p;
  while (p != e && nc < 13) {
    if (*p == '\t') col[nc++] = p + 1;
    ++p;
  }
  if (nc < 12) return false;
  auto span_end = [&](int i) {
    const char* q = col[i];
    while (q != e && *q != '\t') ++q;
    return q;
  };
  auto to_ll = [&](int i, int64_t* out) {
    int64_t v = 0;
    const char* q = col[i];
    bool any = false;
    for (; q != e && *q >= '0' && *q <= '9'; ++q) {
      v = v * 10 + (*q - '0');
      any = true;
    }
    if (!any || (q != e && *q != '\t')) return false;
    *out = v;
    return true;
  };
  rec->query_name.assign(col[0], span_end(0));
  rec->target_name.assign(col[5], span_end(5));
  rec->reverse = (col[4] != e && *col[4] == '-');
  if (!to_ll(1, &rec->query_len) || !to_ll(2, &rec->query_start) ||
      !to_ll(3, &rec->query_end) || !to_ll(6, &rec->target_len) ||
      !to_ll(7, &rec->target_start) || !to_ll(8, &rec->target_end)) {
    return false;
  }
  // tags: find cg:Z:
  for (const char* q = nc > 12 ? col[12] : e; q < e;) {
    const char* fe = q;
    while (fe != e && *fe != '\t') ++fe;
    if (fe - q > 5 && q[0] == 'c' && q[1] == 'g' && q[2] == ':' &&
        q[3] == 'Z' && q[4] == ':') {
      rec->cigar = parse_cigar(q + 5, fe);
    }
    q = fe == e ? e : fe + 1;
  }
  return true;
}

void PafRecord::build_checkpoints() {
  ckpt_tpos.clear();
  ckpt_qpos.clear();
  int64_t tpos = target_start, qpos = 0;
  for (size_t i = 0; i < cigar.size(); ++i) {
    if (i % static_cast<size_t>(kCkptStride) == 0) {
      ckpt_tpos.push_back(tpos);
      ckpt_qpos.push_back(qpos);
    }
    const CigarOp& op = cigar[i];
    switch (op.op) {
      case '=': case 'M': case 'X': tpos += op.len; qpos += op.len; break;
      case 'I': case 'S': qpos += op.len; break;
      case 'D': case 'N': tpos += op.len; break;
      case 'H': break;
      default: tpos += op.len; qpos += op.len; break;
    }
  }
}

size_t PafRecord::seek(int64_t start, int64_t* tpos, int64_t* qpos) const {
  *tpos = target_start;
  *qpos = 0;
  if (ckpt_tpos.empty()) return 0;
  // binary search: last checkpoint with tpos <= start
  size_t lo = 0, hi = ckpt_tpos.size();
  while (lo + 1 < hi) {
    size_t mid = (lo + hi) / 2;
    if (ckpt_tpos[mid] <= start) lo = mid; else hi = mid;
  }
  if (ckpt_tpos[lo] > start) return 0;
  *tpos = ckpt_tpos[lo];
  *qpos = ckpt_qpos[lo];
  return lo * static_cast<size_t>(kCkptStride);
}

// Plain (non-gzip) PAF: mmap + parse lines in parallel byte ranges.  The
// gzgets path copied the whole file through zlib line by line and parsed
// serially — ~1.5 s of every scan's setup for a chromosome-scale PAF.
bool PafIndex::try_mmap_parse(const std::string& path) {
  const int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    ::close(fd);
    return false;
  }
  unsigned char magic[2] = {0, 0};
  if (::pread(fd, magic, 2, 0) != 2 ||
      (magic[0] == 0x1f && magic[1] == 0x8b)) {
    ::close(fd);
    return false;  // gzip -> caller's zlib path
  }
  const size_t sz = static_cast<size_t>(st.st_size);
  void* m = ::mmap(nullptr, sz, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (m == MAP_FAILED) return false;
  const char* base = static_cast<const char*>(m);

  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const unsigned nt = static_cast<unsigned>(
      std::min<size_t>(hw, (sz + (1 << 20) - 1) >> 20));  // >=1 MB/chunk
  // chunk boundaries snapped forward to the next newline
  std::vector<size_t> bound(nt + 1, sz);
  bound[0] = 0;
  for (unsigned t = 1; t < nt; ++t) {
    size_t p = sz / nt * t;
    const void* nl = memchr(base + p, '\n', sz - p);
    bound[t] = nl ? static_cast<size_t>(static_cast<const char*>(nl) - base) + 1
                  : sz;
  }
  std::vector<std::vector<PafRecord>> parts(nt);
  std::vector<std::thread> pool;
  auto parse_span = [&](unsigned t) {
    const char* p = base + bound[t];
    const char* endp = base + bound[t + 1];
    auto& out = parts[t];
    while (p < endp) {
      const void* nl = memchr(p, '\n', static_cast<size_t>(endp - p));
      const char* le = nl ? static_cast<const char*>(nl) : endp;
      const char* trimmed = le;
      while (trimmed > p && trimmed[-1] == '\r') --trimmed;
      if (trimmed > p) {
        PafRecord rec;
        if (parse_line(p, trimmed, &rec)) {
          rec.build_checkpoints();
          out.push_back(std::move(rec));
        }
      }
      p = le == endp ? endp : le + 1;
    }
  };
  if (nt <= 1) {
    parse_span(0);
  } else {
    pool.reserve(nt);
    for (unsigned t = 0; t < nt; ++t) pool.emplace_back(parse_span, t);
    for (auto& th : pool) th.join();
  }
  size_t total = 0;
  for (auto& pt : parts) total += pt.size();
  records_.reserve(total);
  for (auto& pt : parts) {
    for (auto& r : pt) records_.push_back(std::move(r));
  }
  ::munmap(m, sz);
  return true;
}

// ------------------------------------------------- persistent index cache
//
// Binary sidecar `<paf>.impopidx` (the impg `.impg` index capability,
// doc/where_hprc_data.md:14-26): loading it replaces the text tokenise +
// CIGAR parse — the single largest stage of a fresh scan's setup, paid
// once per panel by the panels-tajd/panels-hfst batch drivers which
// reopen one PAF per panel run.  Ops pack into u32 (3-bit op code, 29-bit length — covers
// chromosome-scale runs; longer lengths abort the save and fall back to
// parsing).  Validated against source size + mtime(ns); version-gated.

static constexpr uint32_t kIdxVersion = 1;
static const char kIdxMagic[4] = {'I', 'P', 'X', 'I'};
static const char kOpDecode[9] = "M=XIDNSH";

static int op_code(char op) {
  switch (op) {
    case 'M': return 0; case '=': return 1; case 'X': return 2;
    case 'I': return 3; case 'D': return 4; case 'N': return 5;
    case 'S': return 6; case 'H': return 7;
    default: return -1;
  }
}

struct IdxHeader {
  char magic[4];
  uint32_t version;
  int64_t src_size;
  int64_t src_mtime_s;
  int64_t src_mtime_ns;
  uint64_t n_records;
};

static bool idx_disabled() {
  const char* v = ::getenv("IMPOP_PAF_INDEX");
  return v && v[0] == '0';
}

static bool src_stat(const std::string& path, struct stat* st) {
  return ::stat(path.c_str(), st) == 0;
}

bool PafIndex::try_load_cache(const std::string& path) {
  if (idx_disabled()) return false;
  struct stat src;
  if (!src_stat(path, &src)) return false;
  const std::string ipath = path + ".impopidx";
  const int fd = ::open(ipath.c_str(), O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0 ||
      st.st_size < static_cast<int64_t>(sizeof(IdxHeader))) {
    ::close(fd);
    return false;
  }
  const size_t sz = static_cast<size_t>(st.st_size);
  void* m = ::mmap(nullptr, sz, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (m == MAP_FAILED) return false;
  const char* p = static_cast<const char*>(m);
  const char* endp = p + sz;
  IdxHeader hdr;
  std::memcpy(&hdr, p, sizeof(hdr));
  p += sizeof(hdr);
  if (std::memcmp(hdr.magic, kIdxMagic, 4) != 0 ||
      hdr.version != kIdxVersion || hdr.src_size != src.st_size ||
      hdr.src_mtime_s != static_cast<int64_t>(src.st_mtim.tv_sec) ||
      hdr.src_mtime_ns != static_cast<int64_t>(src.st_mtim.tv_nsec)) {
    ::munmap(m, sz);
    return false;
  }
  auto fail = [&]() {
    records_.clear();
    ::munmap(m, sz);
    return false;
  };
  records_.resize(hdr.n_records);
  for (uint64_t i = 0; i < hdr.n_records; ++i) {
    PafRecord& rec = records_[i];
    auto rd = [&](void* out, size_t nbytes) {
      if (p + nbytes > endp) return false;
      std::memcpy(out, p, nbytes);
      p += nbytes;
      return true;
    };
    uint32_t ln = 0;
    if (!rd(&ln, 4) || p + ln > endp) return fail();
    rec.query_name.assign(p, ln);
    p += ln;
    if (!rd(&ln, 4) || p + ln > endp) return fail();
    rec.target_name.assign(p, ln);
    p += ln;
    uint8_t rev = 0;
    if (!rd(&rec.query_len, 8) || !rd(&rec.query_start, 8) ||
        !rd(&rec.query_end, 8) || !rd(&rev, 1) ||
        !rd(&rec.target_len, 8) || !rd(&rec.target_start, 8) ||
        !rd(&rec.target_end, 8)) {
      return fail();
    }
    rec.reverse = rev != 0;
    uint64_t n_ops = 0;
    if (!rd(&n_ops, 8) || p + n_ops * 4 > endp) return fail();
    rec.cigar.resize(n_ops);
    const uint32_t* ops = reinterpret_cast<const uint32_t*>(p);
    for (uint64_t k = 0; k < n_ops; ++k) {
      uint32_t w;
      std::memcpy(&w, ops + k, 4);  // alignment-safe
      rec.cigar[k].op = kOpDecode[w >> 29];
      rec.cigar[k].len = static_cast<int64_t>(w & 0x1FFFFFFFu);
    }
    p += n_ops * 4;
  }
  ::munmap(m, sz);
  // checkpoints are rebuilt (linear pass), parallel over records
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const unsigned nt = static_cast<unsigned>(
      std::min<size_t>(hw, records_.size() ? records_.size() : 1));
  std::atomic<size_t> next{0};
  auto worker = [&]() {
    for (;;) {
      const size_t i = next.fetch_add(1);
      if (i >= records_.size()) break;
      records_[i].build_checkpoints();
    }
  };
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (unsigned t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return true;
}

void PafIndex::save_cache(const std::string& path) const {
  if (idx_disabled()) return;
  struct stat src;
  if (!src_stat(path, &src)) return;
  for (const auto& rec : records_) {
    for (const auto& op : rec.cigar) {
      if (op.len >= (1LL << 29) || op_code(op.op) < 0) return;
    }
  }
  const std::string ipath = path + ".impopidx";
  const std::string tpath = ipath + ".tmp";
  FILE* f = ::fopen(tpath.c_str(), "wb");
  if (!f) return;
  IdxHeader hdr;
  std::memcpy(hdr.magic, kIdxMagic, 4);
  hdr.version = kIdxVersion;
  hdr.src_size = src.st_size;
  hdr.src_mtime_s = static_cast<int64_t>(src.st_mtim.tv_sec);
  hdr.src_mtime_ns = static_cast<int64_t>(src.st_mtim.tv_nsec);
  hdr.n_records = records_.size();
  bool ok = ::fwrite(&hdr, sizeof(hdr), 1, f) == 1;
  std::vector<uint32_t> packed;
  for (const auto& rec : records_) {
    if (!ok) break;
    const uint32_t ql = static_cast<uint32_t>(rec.query_name.size());
    const uint32_t tl = static_cast<uint32_t>(rec.target_name.size());
    const uint8_t rev = rec.reverse ? 1 : 0;
    const uint64_t n_ops = rec.cigar.size();
    packed.resize(n_ops);
    for (uint64_t k = 0; k < n_ops; ++k) {
      packed[k] = (static_cast<uint32_t>(op_code(rec.cigar[k].op)) << 29) |
                  static_cast<uint32_t>(rec.cigar[k].len);
    }
    ok = ::fwrite(&ql, 4, 1, f) == 1 &&
         (ql == 0 || ::fwrite(rec.query_name.data(), ql, 1, f) == 1) &&
         ::fwrite(&tl, 4, 1, f) == 1 &&
         (tl == 0 || ::fwrite(rec.target_name.data(), tl, 1, f) == 1) &&
         ::fwrite(&rec.query_len, 8, 1, f) == 1 &&
         ::fwrite(&rec.query_start, 8, 1, f) == 1 &&
         ::fwrite(&rec.query_end, 8, 1, f) == 1 &&
         ::fwrite(&rev, 1, 1, f) == 1 &&
         ::fwrite(&rec.target_len, 8, 1, f) == 1 &&
         ::fwrite(&rec.target_start, 8, 1, f) == 1 &&
         ::fwrite(&rec.target_end, 8, 1, f) == 1 &&
         ::fwrite(&n_ops, 8, 1, f) == 1 &&
         (n_ops == 0 ||
          ::fwrite(packed.data(), 4, n_ops, f) == n_ops);
  }
  ok = (::fclose(f) == 0) && ok;
  if (ok) {
    ::rename(tpath.c_str(), ipath.c_str());
  } else {
    ::remove(tpath.c_str());
  }
}

PafIndex::PafIndex(const std::string& path) {
  if (try_load_cache(path)) {
    build_target_index();
    return;
  }
  if (try_mmap_parse(path)) {
    build_target_index();
    save_cache(path);
    return;
  }
  gzFile gz = gzopen(path.c_str(), "rb");  // handles plain files too
  if (!gz) {
    throw std::runtime_error("cannot open PAF: " + path);
  }
  // Streaming batches of lines, parsed in parallel: CIGAR parsing +
  // checkpoint builds dominate index construction (~1 s per chromosome
  // of 466 alignments), and batching bounds memory to ~64 raw lines.
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  std::vector<std::string> batch;
  auto flush_batch = [&]() {
    if (batch.empty()) return;
    const size_t base = records_.size();
    records_.resize(base + batch.size());
    std::vector<char> ok(batch.size(), 0);
    const unsigned nt =
        std::min<size_t>(hw, batch.size());
    std::atomic<size_t> next{0};
    auto worker = [&]() {
      for (;;) {
        const size_t i = next.fetch_add(1);
        if (i >= batch.size()) break;
        PafRecord rec;
        if (parse_line(batch[i].data(), batch[i].data() + batch[i].size(),
                       &rec)) {
          rec.build_checkpoints();
          records_[base + i] = std::move(rec);
          ok[i] = 1;
        }
      }
    };
    if (nt <= 1) {
      worker();
    } else {
      std::vector<std::thread> pool;
      pool.reserve(nt);
      for (unsigned t = 0; t < nt; ++t) pool.emplace_back(worker);
      for (auto& th : pool) th.join();
    }
    // compact out failed parses, preserving order
    size_t keep = base;
    for (size_t i = 0; i < batch.size(); ++i) {
      if (!ok[i]) continue;
      if (keep != base + i) records_[keep] = std::move(records_[base + i]);
      ++keep;
    }
    records_.resize(keep);
    batch.clear();
  };
  std::string line;
  std::vector<char> buf(1 << 20);
  while (true) {
    char* got = gzgets(gz, buf.data(), static_cast<int>(buf.size()));
    if (!got) break;
    line.assign(got);
    // handle lines longer than the buffer
    while (!line.empty() && line.back() != '\n' && !gzeof(gz)) {
      got = gzgets(gz, buf.data(), static_cast<int>(buf.size()));
      if (!got) break;
      line += got;
    }
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r')) {
      line.pop_back();
    }
    if (line.empty()) continue;
    batch.push_back(std::move(line));
    line.clear();
    if (batch.size() >= 64) flush_batch();
  }
  flush_batch();
  gzclose(gz);
  build_target_index();
  save_cache(path);
}

void PafIndex::build_target_index() {
  for (size_t i = 0; i < records_.size(); ++i) {
    by_target_[records_[i].target_name].push_back(i);
  }
  for (auto& [_, idxs] : by_target_) {
    std::sort(idxs.begin(), idxs.end(), [&](size_t a, size_t b) {
      return records_[a].target_start < records_[b].target_start;
    });
  }
}

std::vector<const PafRecord*> PafIndex::overlapping(const std::string& target,
                                                    int64_t start,
                                                    int64_t end) const {
  std::vector<const PafRecord*> out;
  auto it = by_target_.find(target);
  if (it == by_target_.end()) return out;
  for (size_t idx : it->second) {
    const PafRecord& r = records_[idx];
    if (r.target_start >= end) break;  // sorted by start
    if (r.target_end > start) out.push_back(&r);
  }
  return out;
}

}  // namespace impop
