// Native host-side data plane of the port (iinsvae_torch/runtime/native.py,
// iinsvae_torch/runtime/cache.py, iinsvae_torch/data/ewine.py), a copy of
// the JAX package's runtime_native/iinsvae_io.cc: a zero-dependency CSV
// parser (the eWine measurement files), the eWine CIR/error extraction,
// the 6-feature extraction of the SVM baseline and the StandardScaler (both
// not bound yet), and the memory-mapped cache of an assembled split.
//
// One change from that copy: iins_cache_write writes its temporary file
// under a name of its own process (path.<pid>.tmp), so processes writing the
// same cache at once never write into one file; the last rename wins and
// every reader sees a whole file. The cache's byte layout is unchanged, so a
// cache written by either package reads in the other.
//
// Built with the batcher and the server into one library by native.py.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- csv ----

// Parse a comma-separated numeric CSV. skip_header != 0 drops the first
// line. Returns a malloc'd row-major double array (caller frees with
// iins_free); *rows/*cols receive the shape. Returns nullptr on error.
double* iins_read_csv(const char* path, int skip_header, int64_t* rows,
                      int64_t* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (std::fread(buf.data(), 1, static_cast<size_t>(size), f) !=
      static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  std::vector<double> values;
  values.reserve(static_cast<size_t>(size) / 8);
  int64_t n_rows = 0;
  int64_t n_cols = -1;

  const char* p = buf.data();
  const char* end = p + buf.size();
  if (skip_header) {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  while (p < end) {
    // skip empty lines
    if (*p == '\n' || *p == '\r') {
      ++p;
      continue;
    }
    int64_t row_cols = 0;
    while (p < end && *p != '\n') {
      char* next = nullptr;
      double v = std::strtod(p, &next);
      if (next == p) {  // non-numeric field -> NaN, skip to delimiter
        v = std::nan("");
        while (p < end && *p != ',' && *p != '\n' && *p != '\r') ++p;
        next = const_cast<char*>(p);
      }
      values.push_back(v);
      ++row_cols;
      p = next;
      while (p < end && (*p == ',' || *p == '\r' || *p == ' ')) {
        if (*p == ',') {
          ++p;
          break;
        }
        ++p;
      }
    }
    if (p < end) ++p;  // newline
    if (n_cols < 0) n_cols = row_cols;
    if (row_cols < n_cols) {  // short ragged row: pad with NaN
      while (row_cols < n_cols) {
        values.push_back(std::nan(""));
        ++row_cols;
      }
    } else if (row_cols > n_cols) {
      // over-long ragged row: drop the extra fields — keeping them would
      // break the row-major (rows, cols) layout the caller reshapes to
      values.resize(values.size() - static_cast<size_t>(row_cols - n_cols));
    }
    ++n_rows;
  }

  if (n_rows == 0) n_cols = 0;  // empty / header-only file -> (0, 0)
  double* out = static_cast<double*>(
      std::malloc(values.empty() ? 1 : values.size() * sizeof(double)));
  if (!out) return nullptr;
  std::memcpy(out, values.data(), values.size() * sizeof(double));
  *rows = n_rows;
  *cols = n_cols;
  return out;
}

void iins_free(double* p) { std::free(p); }

// -------------------------------------------------------------- ewine ----

// Row layout (reference data_tools.py:93-107): cols 0-1 tag xy, 2-3 anchor
// xy, 4 measured distance, 5 NLOS label, 8 first-path index, 17 max
// amplitude; CIR taps start at fp_idx + 15, 152 taps, amplitude-normalized.
void iins_ewine_extract(const double* rows, int64_t n, int64_t cols,
                        double* cir, double* err, double* label) {
  const int64_t kCirLen = 152;
  // rows too narrow for the metadata columns or one CIR window cannot be
  // extracted at all (the python wrapper rejects these earlier; this is the
  // in-library guard for direct callers)
  if (cols < 18 || cols < kCirLen) {
    for (int64_t i = 0; i < n; ++i) {
      err[i] = std::nan("");
      label[i] = std::nan("");
      for (int64_t t = 0; t < kCirLen; ++t) cir[i * kCirLen + t] = std::nan("");
    }
    return;
  }
  const int64_t max_start = cols - kCirLen;
  for (int64_t i = 0; i < n; ++i) {
    const double* r = rows + i * cols;
    double dx = r[0] - r[2];
    double dy = r[1] - r[3];
    err[i] = std::fabs(std::sqrt(dx * dx + dy * dy) - r[4]);
    label[i] = r[5];
    // first-path index comes from FILE DATA — clamp the 152-tap window into
    // the row so a malformed/hostile fp_idx can never read out of bounds
    // (matches data/ewine.py's extract_reg_arrays; identity on valid rows).
    // The clamp happens in the DOUBLE domain: casting a NaN/out-of-range
    // double straight to int64 is UB, and the CSV parser emits NaN for
    // non-numeric fields.
    double fpd = std::isfinite(r[8]) ? r[8] : 0.0;
    double sf = fpd + 15.0;
    int64_t start = sf <= 0.0 ? 0
                    : sf >= static_cast<double>(max_start)
                        ? max_start
                        : static_cast<int64_t>(sf);
    double amp = r[17];
    const double* src = r + start;
    double* dst = cir + i * kCirLen;
    for (int64_t t = 0; t < kCirLen; ++t) dst[t] = src[t] / amp;
  }
}

// ----------------------------------------------------------- features ----

// 6 hand-crafted CIR features per sample, column order
// [Er, T_EMD, T_RMS, Kur, R_T, M_AMP] — the semantics of the JAX package's
// ops/features.py (reference data_tools.py:340-414 with the kurtosis power-4
// intent fix).
void iins_features(const double* cir, int64_t n, int64_t len, double* out) {
  const int64_t kW = 35;
  for (int64_t i = 0; i < n; ++i) {
    const double* x = cir + i * len;
    // max amplitude + argmax (first maximum)
    double m_amp = x[0];
    int64_t max_pos = 0;
    double mean = 0.0;
    for (int64_t t = 0; t < len; ++t) {
      if (x[t] > m_amp) {
        m_amp = x[t];
        max_pos = t;
      }
      mean += x[t];
    }
    mean /= static_cast<double>(len);
    double var = 0.0;
    for (int64_t t = 0; t < len; ++t) {
      double d = x[t] - mean;
      var += d * d;
    }
    double sigma = std::sqrt(var / static_cast<double>(len));  // biased

    // rise time: first crossings (0 when absent)
    double th1 = 6.0 * (sigma + mean);
    double th2 = 0.6 * m_amp;
    int64_t t1 = 0, t2 = 0;
    for (int64_t t = 0; t < len; ++t)
      if (x[t] > th1) {
        t1 = t;
        break;
      }
    for (int64_t t = 0; t < len; ++t)
      if (x[t] > th2) {
        t2 = t;
        break;
      }
    double r_t = static_cast<double>(std::max<int64_t>(0, t2 - t1));

    // 35-tap window around the peak, clamped
    int64_t start = std::clamp<int64_t>(max_pos - 20, 0, len - kW);
    const double* w = x + start;

    double er = 0.0;
    for (int64_t t = 0; t < kW; ++t) er += w[t];
    double t_emd = 0.0, t_rms = 0.0;
    for (int64_t t = 0; t < kW; ++t) {
      double fhi = w[t] * w[t] / er;
      double i1 = static_cast<double>(t + 1);
      double i2 = static_cast<double>(t + 2);
      t_emd += i1 * fhi;
      double a = i1 - i2 * fhi;
      t_rms += a * a * fhi;
    }

    double mu = er / static_cast<double>(kW);
    double s2 = 0.0;
    for (int64_t t = 0; t < kW; ++t) {
      double d = w[t] - mu;
      s2 += d * d;
    }
    s2 /= static_cast<double>(kW);
    double kur = 0.0;
    for (int64_t t = 0; t < kW; ++t) {
      double d = w[t] - mu;
      kur += d * d * d * d;
    }
    kur /= static_cast<double>(kW) * s2 * s2;

    double* o = out + i * 6;
    o[0] = er;
    o[1] = t_emd;
    o[2] = t_rms;
    o[3] = kur;
    o[4] = r_t;
    o[5] = m_amp;
  }
}

// ----------------------------------------------------------- scaling ----

// StandardScaler: fit per-column mean/std (biased) on (n, d) train data,
// then transform in place. Columns with zero std are left unscaled.
void iins_standardize_fit(const double* x, int64_t n, int64_t d, double* mean,
                          double* std_out) {
  for (int64_t j = 0; j < d; ++j) {
    mean[j] = 0.0;
    std_out[j] = 0.0;
  }
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < d; ++j) mean[j] += x[i * d + j];
  for (int64_t j = 0; j < d; ++j) mean[j] /= static_cast<double>(n);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < d; ++j) {
      double v = x[i * d + j] - mean[j];
      std_out[j] += v * v;
    }
  for (int64_t j = 0; j < d; ++j) {
    std_out[j] = std::sqrt(std_out[j] / static_cast<double>(n));
    if (std_out[j] == 0.0) std_out[j] = 1.0;
  }
}

void iins_standardize_apply(double* x, int64_t n, int64_t d,
                            const double* mean, const double* std_in) {
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < d; ++j)
      x[i * d + j] = (x[i * d + j] - mean[j]) / std_in[j];
}

}  // extern "C"

// ------------------------------------------------------- binary cache ----
//
// Memory-mapped dataset cache: after the first parse+split, the assembled
// arrays are written once into a single aligned binary file; subsequent
// runs mmap it (zero parse, zero copy until first touch). Replaces the
// reference's ~270 s pandas reload on every launch (dataset.py:192).
//
// Layout: 8-byte magic "IINSC01\0", int64 n_arrays, then n_arrays records
// of {char name[16]; int64 dtype (0=f32,1=f64,2=i64); int64 ndim;
// int64 dims[4]; int64 offset}, then 64-byte-aligned array payloads.

namespace {

constexpr char kMagic[8] = {'I', 'I', 'N', 'S', 'C', '0', '1', '\0'};

struct CacheRecord {
  char name[16];
  int64_t dtype;
  int64_t ndim;
  int64_t dims[4];
  int64_t offset;
};

struct CacheHandle {
  void* base;
  int64_t size;
  int64_t n_arrays;
  const CacheRecord* records;
};

int64_t dtype_size(int64_t dtype) {
  switch (dtype) {
    case 0: return 4;   // f32
    case 1: return 8;   // f64
    case 2: return 8;   // i64
    default: return 0;
  }
}

int64_t record_elems(const CacheRecord& r) {
  int64_t n = 1;
  for (int64_t i = 0; i < r.ndim; ++i) n *= r.dims[i];
  return n;
}

}  // namespace

extern "C" {

// Write arrays to `path` atomically (a temporary file of this process +
// rename). Returns 0 on success. names: n null-terminated strings (<=15
// chars); dims row-major (n, 4) with unused trailing dims = 1.
int64_t iins_cache_write(const char* path, int64_t n, const char** names,
                         const int64_t* dtypes, const int64_t* ndims,
                         const int64_t* dims, const void** datas) {
  std::string tmp =
      std::string(path) + "." + std::to_string(static_cast<long>(getpid())) + ".tmp";
  FILE* f = std::fopen(tmp.c_str(), "wb");
  if (!f) return -1;

  std::vector<CacheRecord> recs(static_cast<size_t>(n));
  int64_t offset = 8 + 8 + n * static_cast<int64_t>(sizeof(CacheRecord));
  for (int64_t i = 0; i < n; ++i) {
    CacheRecord& r = recs[static_cast<size_t>(i)];
    std::memset(&r, 0, sizeof(r));
    std::snprintf(r.name, sizeof(r.name), "%s", names[i]);
    r.dtype = dtypes[i];
    r.ndim = ndims[i];
    if (r.ndim < 1 || r.ndim > 4 || dtype_size(r.dtype) == 0) {
      std::fclose(f);
      std::remove(tmp.c_str());
      return -2;
    }
    for (int64_t d = 0; d < 4; ++d) r.dims[d] = d < r.ndim ? dims[i * 4 + d] : 1;
    offset = (offset + 63) & ~int64_t{63};  // 64-byte alignment
    r.offset = offset;
    offset += record_elems(r) * dtype_size(r.dtype);
  }

  bool ok = std::fwrite(kMagic, 1, 8, f) == 8 &&
            std::fwrite(&n, 8, 1, f) == 1 &&
            std::fwrite(recs.data(), sizeof(CacheRecord),
                        static_cast<size_t>(n), f) == static_cast<size_t>(n);
  for (int64_t i = 0; ok && i < n; ++i) {
    const CacheRecord& r = recs[static_cast<size_t>(i)];
    long pos = std::ftell(f);
    for (; pos < r.offset; ++pos) std::fputc(0, f);
    int64_t bytes = record_elems(r) * dtype_size(r.dtype);
    ok = std::fwrite(datas[i], 1, static_cast<size_t>(bytes), f) ==
         static_cast<size_t>(bytes);
  }
  if (std::fclose(f) != 0) ok = false;
  if (!ok || std::rename(tmp.c_str(), path) != 0) {
    std::remove(tmp.c_str());
    return -3;
  }
  return 0;
}

// mmap `path`; returns an opaque handle (nullptr on error / bad magic).
void* iins_cache_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                    MAP_PRIVATE, fd, 0);
  ::close(fd);  // mapping keeps the file alive
  if (base == MAP_FAILED) return nullptr;
  if (std::memcmp(base, kMagic, 8) != 0) {
    munmap(base, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  // Validate the whole header before trusting it: a truncated or corrupt
  // file must read as a cache MISS (caller rebuilds), never as an
  // out-of-bounds access. n_arrays bounds the record table inside the
  // mapping; every record's name NUL, dtype, ndim, dims and payload span
  // are checked with overflow-safe arithmetic.
  int64_t n_arrays;
  std::memcpy(&n_arrays, static_cast<char*>(base) + 8, 8);
  const int64_t rec_sz = static_cast<int64_t>(sizeof(CacheRecord));
  bool ok = n_arrays >= 0 && n_arrays <= (st.st_size - 16) / rec_sz;
  const auto* records =
      reinterpret_cast<const CacheRecord*>(static_cast<char*>(base) + 16);
  const int64_t hdr_end = 16 + n_arrays * rec_sz;
  for (int64_t i = 0; ok && i < n_arrays; ++i) {
    const CacheRecord& r = records[i];
    int64_t esz = dtype_size(r.dtype);
    ok = r.name[15] == '\0' && esz > 0 && r.ndim >= 1 && r.ndim <= 4 &&
         r.offset >= hdr_end && r.offset <= st.st_size;
    if (!ok) break;
    int64_t max_elems = (st.st_size - r.offset) / esz;
    int64_t elems = 1;
    for (int64_t d = 0; ok && d < 4; ++d) {
      ok = r.dims[d] >= 0 &&
           (r.dims[d] == 0 || elems <= max_elems / r.dims[d]);
      if (ok) elems *= r.dims[d];
    }
    ok = ok && elems <= max_elems;
  }
  if (!ok) {
    munmap(base, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  auto* h = new CacheHandle;
  h->base = base;
  h->size = st.st_size;
  h->n_arrays = n_arrays;
  h->records = records;
  return h;
}

int64_t iins_cache_count(void* handle) {
  return handle ? static_cast<CacheHandle*>(handle)->n_arrays : 0;
}

// Fill name/dtype/ndim/dims for array #i; returns the data pointer into the
// mapping (valid until iins_cache_close), or nullptr when out of range or
// the record would point outside the file.
const void* iins_cache_array(void* handle, int64_t i, char* name16,
                             int64_t* dtype, int64_t* ndim, int64_t* dims4) {
  auto* h = static_cast<CacheHandle*>(handle);
  if (!h || i < 0 || i >= h->n_arrays) return nullptr;
  const CacheRecord& r = h->records[i];
  int64_t bytes = record_elems(r) * dtype_size(r.dtype);
  if (r.offset < 0 || r.offset + bytes > h->size) return nullptr;
  std::memcpy(name16, r.name, 16);
  *dtype = r.dtype;
  *ndim = r.ndim;
  for (int64_t d = 0; d < 4; ++d) dims4[d] = r.dims[d];
  return static_cast<const char*>(h->base) + r.offset;
}

void iins_cache_close(void* handle) {
  auto* h = static_cast<CacheHandle*>(handle);
  if (!h) return;
  munmap(h->base, static_cast<size_t>(h->size));
  delete h;
}

}  // extern "C"
