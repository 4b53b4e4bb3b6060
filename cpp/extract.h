// impop_tpu native extraction layer.
//
// Replaces the *capabilities consumed* from the reference's external native
// tools (SURVEY.md §2.2): impg's region projection through a PAF alignment
// (impg similarity / impg query, reference run_pica2_impg.sh:162-168,
// run_tajd.sh:126) and povu's variant decomposition (run_tajd.sh:148) —
// re-designed to emit the haplotype-by-site allele matrices the JAX engine
// consumes directly, instead of per-window pairwise alignment products.
//
// Pipeline: PAF(+CIGAR, target = reference assembly) + FASTA(.fai) sequence
// store -> per-window: overlapping alignments -> CIGAR walk -> per-haplotype
// variant calls vs the reference -> union of variant keys = site axis ->
// int8 matrix (1 = variant allele, 0 = reference allele, -1 = not covered).
// Identity matrices / segregating sites / AFS all derive from this matrix on
// the device (impop_tpu/stats/allele.py).
#pragma once

#include <cstdint>
#include <fstream>
#include <map>
#include <string>
#include <unordered_map>
#include <vector>

namespace impop {

// ------------------------------------------------------------------ fasta

// FAI-indexed random access to a FASTA file.
//
// Three storage kinds are detected at open (the reference pipeline's data
// substrate is bgzip FASTA converted from the HPRC AGC archive,
// reference doc/where_hprc_data.md:14-26):
//  - plain text:   pread of the covering byte range (thread-safe);
//  - BGZF (bgzip): a block index (compressed offset, uncompressed offset)
//    built by scanning the 18-byte BGZF headers — persisted/loaded in the
//    samtools ``.gzi`` format — with per-fetch inflation of only the blocks
//    covering the requested range;
//  - plain gzip:   no random access is possible in a single-member stream,
//    so the file is inflated into memory once at open (documented: use
//    bgzip for large stores).
// FAI offsets are always in UNCOMPRESSED coordinates (samtools convention).
class FastaReader {
 public:
  // Opens path; builds <path>.fai (and <path>.gzi for BGZF) if absent.
  explicit FastaReader(const std::string& path);
  bool has(const std::string& name) const;
  // 0-based half-open [start, end) slice; clamps to sequence length.
  std::string fetch(const std::string& name, int64_t start, int64_t end) const;
  int64_t length(const std::string& name) const;

  // O(1) zero-copy per-base access bound to one sequence — plain files are
  // mmap'd at open, whole-file-inflated gzip serves from memory.  BGZF has
  // no O(1) path (invalid view; callers fall back to fetch()).  This is what
  // lets the range walker touch only the query bytes at variant sites
  // instead of materialising every window's query slice.
  class BaseView {
   public:
    bool valid() const { return data_ != nullptr; }
    // Raw byte (no case normalisation); 'N' outside [0, length).
    char at(int64_t pos) const {
      if (pos < 0 || pos >= len_) return 'N';
      return data_[pos / line_bases_ * line_bytes_ + pos % line_bases_];
    }

    // Amortised-O(1) sequential access: at() pays two 64-bit divisions per
    // base, which dominated the range walk's SNP emissions (one query-base
    // read per mismatch per record).  A cursor tracks (byte ptr, column)
    // and moves by the position delta; walks touch bases in monotone order
    // (either direction), so the line-boundary loops amortise to
    // O(span / line_bases) per record instead of O(divs per base).
    class Cursor {
     public:
      Cursor() = default;
      explicit Cursor(const BaseView& v)
          : data_(v.data_), len_(v.len_), lb_(v.line_bases_),
            extra_(v.line_bytes_ - v.line_bases_), p_(v.data_) {}
      char get(int64_t pos) {
        if (pos < 0 || pos >= len_) return 'N';
        const int64_t d = pos - cur_;
        cur_ = pos;
        col_ += d;
        p_ += d;
        while (col_ >= lb_) { col_ -= lb_; p_ += extra_; }
        while (col_ < 0) { col_ += lb_; p_ -= extra_; }
        // warm the line the NEXT variant will touch: spacing is roughly
        // regular (~hundreds of bases), and the strided pattern defeats
        // the hardware prefetcher (SNP reads measured memory-latency
        // bound, ~45% of the range walk)
        __builtin_prefetch(p_ + (d >= 0 ? 320 : -320));
        return *p_;
      }

     private:
      const char* data_ = nullptr;
      int64_t len_ = 0;
      int64_t lb_ = 1;
      int64_t extra_ = 0;
      int64_t cur_ = 0;
      int64_t col_ = 0;
      const char* p_ = nullptr;
    };

   private:
    friend class FastaReader;
    const char* data_ = nullptr;  // first base of the sequence
    int64_t len_ = 0;
    int64_t line_bases_ = 1;
    int64_t line_bytes_ = 1;
  };
  BaseView base_view(const std::string& name) const;

 private:
  enum class Kind { kPlain, kBgzf, kGzMem };
  struct Entry {
    int64_t length;
    int64_t offset;      // uncompressed offset of first base
    int64_t line_bases;  // bases per line
    int64_t line_bytes;  // bytes per line (incl newline)
  };
  struct Block {
    int64_t coffset;  // compressed file offset of block start
    int64_t uoffset;  // cumulative uncompressed offset
  };
  std::string path_;
  std::unordered_map<std::string, Entry> index_;
  int fd_ = -1;  // pread-based access: thread-safe, no seek state
  Kind kind_ = Kind::kPlain;
  const char* map_ = nullptr;  // mmap of the whole file (kPlain only)
  int64_t map_size_ = 0;
  std::vector<Block> blocks_;  // BGZF block index, uoffset-sorted
  int64_t total_usize_ = 0;    // total uncompressed bytes (BGZF)
  std::string mem_;            // whole inflated file (plain gzip only)
  void detect_kind();
  void build_or_load_block_index();
  void build_or_load_index();
  // Uncompressed byte range [off, off+len) into out; returns bytes read.
  int64_t read_raw(int64_t off, int64_t len, char* out) const;

 public:
  ~FastaReader();
};

// ------------------------------------------------------------------ paf

struct CigarOp {
  char op;      // M, =, X, I, D (N/S/H tolerated)
  int64_t len;
};

struct PafRecord {
  std::string query_name;
  int64_t query_len = 0;
  int64_t query_start = 0;
  int64_t query_end = 0;
  bool reverse = false;
  std::string target_name;
  int64_t target_len = 0;
  int64_t target_start = 0;
  int64_t target_end = 0;
  std::vector<CigarOp> cigar;  // empty if no cg:Z tag

  // CIGAR seek checkpoints every kCkptStride ops: (tpos, qpos) BEFORE op
  // i*kCkptStride — lets a window walk start near its target coordinate
  // instead of from target_start (whole-chromosome alignments have ~1e6
  // ops; per-window re-walks would be O(range) each).
  static constexpr int64_t kCkptStride = 64;
  std::vector<int64_t> ckpt_tpos;
  std::vector<int64_t> ckpt_qpos;
  void build_checkpoints();
  // largest checkpointed op index whose tpos <= start (0 if none)
  size_t seek(int64_t start, int64_t* tpos, int64_t* qpos) const;
};

// Parses a PAF file (plain or gzip) and indexes records by target name.
class PafIndex {
 public:
  explicit PafIndex(const std::string& path);
  // All records overlapping target [start, end).
  std::vector<const PafRecord*> overlapping(const std::string& target,
                                            int64_t start, int64_t end) const;
  size_t size() const { return records_.size(); }

 private:
  // mmap + parallel byte-range parse for plain files; false -> gz path
  bool try_mmap_parse(const std::string& path);
  // persistent binary index sidecar (<paf>.impopidx) — the impg `.impg`
  // index capability: load skips tokenizing/CIGAR-parsing the text PAF
  // entirely (validated against source size+mtime; IMPOP_PAF_INDEX=0
  // disables both load and save)
  bool try_load_cache(const std::string& path);
  void save_cache(const std::string& path) const;
  void build_target_index();

  std::vector<PafRecord> records_;
  // per target: record indices sorted by target_start
  std::unordered_map<std::string, std::vector<size_t>> by_target_;
};

// ------------------------------------------------------------------ window

// One haplotype's calls within a window.
struct HaplotypeCalls {
  std::string name;                 // query (assembly contig) name
  int64_t cover_start = 0;          // covered target span within the window
  int64_t cover_end = 0;
  // variant key -> present; key identifies (target_pos, ref, alt)
  std::vector<uint32_t> variant_ids;
};

struct WindowMatrix {
  std::vector<std::string> names;   // row names (haplotypes), sorted
  std::vector<std::string> site_keys;  // "pos:ref>alt" per column
  std::vector<int64_t> site_pos;    // target positions per column
  int64_t n = 0;                    // rows
  int64_t s = 0;                    // columns
  std::vector<int8_t> geno;         // n*s row-major; 1 alt, 0 ref, -1 uncovered
};

class Extractor {
 public:
  Extractor(const std::string& paf_path, const std::string& fasta_path);
  // Extract window [start, end) on reference sequence `target`.
  // `target` must be the PAF target name (e.g. "CHM13#0#chr1").
  // inner_threads: per-record walk fan-out; 0 = auto (env/hardware), 1 =
  // serial (used by extract_batch, which parallelises over windows instead).
  WindowMatrix extract(const std::string& target, int64_t start,
                       int64_t end, int inner_threads = 0) const;

  // Range extraction: windows must be sorted by start and non-overlapping.
  // Walks each PAF record ONCE over [wins.front().start, wins.back().end)
  // and bins calls into windows — per-window results are bit-identical to
  // per-window extract() (deletions are clipped at window bounds, insertion
  // and coverage boundary rules match; extract() itself delegates here).
  // The reference re-runs its native pipeline per window
  // (run_pica2_impg.sh:126-192); one walk per record per SCAN RANGE is the
  // engine's host-side analogue of batching windows onto the device.
  std::vector<WindowMatrix> extract_windows(
      const std::string& target,
      const std::vector<std::pair<int64_t, int64_t>>& wins,
      int threads = 0) const;

 private:
  PafIndex paf_;
  FastaReader fasta_;
};

// Thread-count policy shared by every parallel stage: explicit argument >
// IMPOP_EXTRACT_THREADS env var > hardware concurrency.  Defined in
// window.cc; the C ABI batch entry points must route through this too so
// the env var bounds the whole extraction pipeline on shared hosts.
int resolve_threads(int threads);

}  // namespace impop
