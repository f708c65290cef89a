// Fast CSV parsers for the session input files and any numeric CSV (C++
// runtime component), built with g++ by pipeline/native.py (the JAX
// package's native/fastcsv.cpp).
//
// Counterpart of the reference's use of fast-cpp-csv-parser for IMU sample
// files (lib/motion/imu_types/ImuDataReader.cpp) and the point-observation
// reader (interfaces/ark/point_observation/PointObservationReader.cpp):
// a 30-minute recording has ~2M IMU rows and ~1M observation rows per file,
// which numpy.genfromtxt parses ~50x slower than this single-pass scanner.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image); the
// caller allocates numpy arrays and passes raw pointers (two-pass:
// count, then fill). A parse returns -2 on a malformed row.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

struct FileBuf {
  std::string data;
  bool ok = false;
  explicit FileBuf(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    data.resize(size);
    ok = std::fread(data.data(), 1, size, f) == static_cast<size_t>(size);
    std::fclose(f);
  }
};

// One data row [p, nl), read field by field. Each field must hold a number
// that ends before the row does, fields are separated by one comma (blanks
// around it allowed), and the row must end after its last field; any other
// row sets ok to false (a missing field, a text field, an extra field).
struct Row {
  const char* p;
  const char* nl;
  bool ok = true;
  bool first = true;

  void skip_blanks() {
    while (p < nl && (*p == ' ' || *p == '\t')) ++p;
  }
  // before a field: the comma that ends the one before it
  bool open_field() {
    if (!first) {
      skip_blanks();
      if (p < nl && *p == ',') ++p;
      else ok = false;
    }
    first = false;
    if (p >= nl) ok = false;
    return ok;
  }
  double dbl() {
    if (!open_field()) return 0.0;
    char* q = nullptr;
    double v = std::strtod(p, &q);
    if (q == p || q > nl) ok = false;
    else p = q;
    return v;
  }
  long long ll() {
    if (!open_field()) return 0;
    char* q = nullptr;
    long long v = std::strtoll(p, &q, 10);
    if (q == p || q > nl) {
      ok = false;
      return 0;
    }
    p = q;
    // a float timestamp (e.g. "123.0") — consume the fraction
    if (p < nl && *p == '.') {
      std::strtod(p, &q);
      if (q > nl) ok = false;
      else p = q;
    }
    return v;
  }
  // after the last field: only blanks (and a CR) up to the newline
  bool end() {
    while (p < nl && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return ok && p == nl;
  }
  // after the last field read: the row ends, or its next field begins
  // (a row's fields past those read are not read)
  bool end_or_more() {
    while (p < nl && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return ok && (p == nl || *p == ',');
  }
};

inline const char* line_end(const char* p, const char* end) {
  const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
  return nl ? nl : end;
}

long count_data_lines(const FileBuf& fb) {
  if (!fb.ok || fb.data.empty()) return -1;
  long n = 0;
  const char* p = fb.data.data();
  const char* end = p + fb.data.size();
  // skip header line
  p = line_end(p, end);
  if (p < end) ++p;
  while (p < end) {
    const char* nl = line_end(p, end);
    if (nl > p && *p != '#') ++n;
    p = nl + 1;
  }
  return n;
}

}  // namespace

extern "C" {

// EuRoC IMU CSV: #timestamp [ns], temperature, w_xyz, a_xyz
long imu_csv_count(const char* path) {
  FileBuf fb(path);
  return count_data_lines(fb);
}

int imu_csv_parse(const char* path, long n, long long* t_ns, double* gyro,
                  double* accel) {
  FileBuf fb(path);
  if (!fb.ok) return -1;
  const char* p = fb.data.data();
  const char* end = p + fb.data.size();
  p = line_end(p, end);
  if (p < end) ++p;
  long i = 0;
  while (p < end && i < n) {
    const char* nl = line_end(p, end);
    if (nl > p && *p != '#') {
      Row r{p, nl};
      t_ns[i] = r.ll();
      r.dbl();  // temperature
      gyro[i * 3 + 0] = r.dbl();
      gyro[i * 3 + 1] = r.dbl();
      gyro[i * 3 + 2] = r.dbl();
      accel[i * 3 + 0] = r.dbl();
      accel[i * 3 + 1] = r.dbl();
      accel[i * 3 + 2] = r.dbl();
      if (!r.end()) return -2;
      ++i;
    }
    p = nl + 1;
  }
  return i == n ? 0 : -2;
}

// session_observations.csv: point_id, capture_timestamp_ns, camera_index,
// projection_base_res_x/y, sqrt_h_base_res_00/01/10/11
long obs_csv_count(const char* path) {
  FileBuf fb(path);
  return count_data_lines(fb);
}

int obs_csv_parse(const char* path, long n, long long* point_id,
                  long long* ts_ns, int* cam, double* uv, double* sqrt_h) {
  FileBuf fb(path);
  if (!fb.ok) return -1;
  const char* p = fb.data.data();
  const char* end = p + fb.data.size();
  p = line_end(p, end);
  if (p < end) ++p;
  long i = 0;
  while (p < end && i < n) {
    const char* nl = line_end(p, end);
    if (nl > p && *p != '#') {
      Row r{p, nl};
      point_id[i] = r.ll();
      ts_ns[i] = r.ll();
      cam[i] = static_cast<int>(r.ll());
      uv[i * 2 + 0] = r.dbl();
      uv[i * 2 + 1] = r.dbl();
      sqrt_h[i * 4 + 0] = r.dbl();
      sqrt_h[i * 4 + 1] = r.dbl();
      sqrt_h[i * 4 + 2] = r.dbl();
      sqrt_h[i * 4 + 3] = r.dbl();
      if (!r.end()) return -2;
      ++i;
    }
    p = nl + 1;
  }
  return i == n ? 0 : -2;
}

// Any numeric CSV: the first n_cols fields of each data row, row-major.
// Each of those must hold a number (a row with fewer fields, or a text
// field among them, is malformed); the fields after them are not read.
long num_csv_count(const char* path) {
  FileBuf fb(path);
  return count_data_lines(fb);
}

int num_csv_parse(const char* path, long n, int n_cols, double* out) {
  FileBuf fb(path);
  if (!fb.ok) return -1;
  const char* p = fb.data.data();
  const char* end = p + fb.data.size();
  p = line_end(p, end);
  if (p < end) ++p;
  long i = 0;
  while (p < end && i < n) {
    const char* nl = line_end(p, end);
    if (nl > p && *p != '#') {
      Row r{p, nl};
      for (int c = 0; c < n_cols; ++c) out[i * n_cols + c] = r.dbl();
      if (!r.end_or_more()) return -2;
      ++i;
    }
    p = nl + 1;
  }
  return i == n ? 0 : -2;
}

}  // extern "C"
