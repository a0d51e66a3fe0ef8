// Native reader for the MultiIK robotics fixture format.
//
// The port's copy of native/ikmat_reader.cpp, with the same C interface:
// host C++ of jrlqp_tpu_torch's IO layer, an independent implementation of
// the format the reference reads in tests/IKmatReader.cpp:
//   - plain matrix files: whitespace-separated doubles, one row per line
//     (readMat, ref :95-104);
//   - composite IK problem files: "==== name ====" section headers (the
//     section name starts at column 5, ref isDataName :34-42) followed by
//     the payload, in the order dim_var, dim_eq, dim_ineq, Q, c, A, b, C,
//     d, x_min, x_max (readIKPbFile, ref :106-146). A 0-row matrix still
//     consumes one (empty) payload line.
//
// Exposed as a C ABI for ctypes (jrlqp_tpu_torch/io/native.py builds it
// with g++ at first use, in one library with qps_parser.cpp).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <vector>

namespace {

struct Lines {
  std::vector<std::string_view> v;
  explicit Lines(std::string_view text) {
    size_t start = 0;
    while (start <= text.size()) {
      size_t nl = text.find('\n', start);
      if (nl == std::string_view::npos) {
        if (start < text.size()) v.push_back(text.substr(start));
        break;
      }
      v.push_back(text.substr(start, nl - start));
      start = nl + 1;
    }
  }
};

bool parse_row(std::string_view line, std::vector<double>* out) {
  out->clear();
  const char* p = line.data();
  const char* end = p + line.size();
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    if (p >= end) break;
    char* next = nullptr;
    std::string tok(p, end - p);  // strtod needs NUL termination
    double val = std::strtod(tok.c_str(), &next);
    if (next == tok.c_str()) return false;
    out->push_back(val);
    p += next - tok.c_str();
  }
  return true;
}

bool is_header(std::string_view line, std::string_view name) {
  // ref isDataName: '=' prefix, name at column 5
  return !line.empty() && line[0] == '=' && line.size() >= 5 + name.size() &&
         line.substr(5, name.size()) == name;
}

struct IKParser {
  const Lines& lines;
  size_t pos = 0;
  std::string error;

  explicit IKParser(const Lines& l) : lines(l) {}

  bool expect(std::string_view name) {
    if (pos >= lines.v.size() || !is_header(lines.v[pos], name)) {
      error = "expected section '" + std::string(name) + "' at line " +
              std::to_string(pos + 1);
      return false;
    }
    ++pos;
    return true;
  }

  bool read_int(int32_t* out) {
    if (pos >= lines.v.size()) {
      error = "unexpected end of file";
      return false;
    }
    std::vector<double> row;
    if (!parse_row(lines.v[pos], &row) || row.empty()) {
      error = "expected integer at line " + std::to_string(pos + 1);
      return false;
    }
    *out = static_cast<int32_t>(row[0]);
    ++pos;
    return true;
  }

  // nrows lines -> row-major (nrows, *ncols) matrix; 0 rows consumes one
  // (empty) line, matching the reference reader.
  bool read_rows(int32_t nrows, std::vector<double>* out, int32_t* ncols) {
    out->clear();
    *ncols = 0;
    if (nrows == 0) {
      if (pos < lines.v.size()) ++pos;
      return true;
    }
    std::vector<double> row;
    for (int32_t i = 0; i < nrows; ++i) {
      if (pos >= lines.v.size()) {
        error = "unexpected end of file in matrix payload";
        return false;
      }
      if (!parse_row(lines.v[pos], &row)) {
        error = "bad number at line " + std::to_string(pos + 1);
        return false;
      }
      if (i == 0) {
        *ncols = static_cast<int32_t>(row.size());
      } else if (static_cast<int32_t>(row.size()) != *ncols) {
        error = "ragged matrix at line " + std::to_string(pos + 1);
        return false;
      }
      out->insert(out->end(), row.begin(), row.end());
      ++pos;
    }
    return true;
  }
};

double* copy_out(const std::vector<double>& v) {
  double* p = static_cast<double*>(std::malloc(v.size() * sizeof(double) + 1));
  std::memcpy(p, v.data(), v.size() * sizeof(double));
  return p;
}

char* copy_str(const std::string& s) {
  char* p = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(p, s.c_str(), s.size() + 1);
  return p;
}

}  // namespace

extern "C" {

// Composite IK problem (min 0.5 x'Qx + c'x s.t. Ax = b, Cx <= d, bounds).
struct IKPbResultC {
  int32_t n, me, mi;
  double *Q, *c, *A, *b, *C, *d, *xmin, *xmax;  // row-major
  char* error;  // non-null on failure
};

// Plain matrix file.
struct MatResultC {
  int32_t rows, cols;
  double* data;  // row-major
  char* error;
};

IKPbResultC* jrlqp_parse_ikpb(const char* text, int64_t len) {
  auto* res = static_cast<IKPbResultC*>(std::calloc(1, sizeof(IKPbResultC)));
  Lines lines(std::string_view(text, static_cast<size_t>(len)));
  IKParser p(lines);
  std::vector<double> Q, c, A, b, C, d, xmin, xmax;
  int32_t n = 0, me = 0, mi = 0, nc = 0;
  bool ok = p.expect("dim_var") && p.read_int(&n) && p.expect("dim_eq") &&
            p.read_int(&me) && p.expect("dim_ineq") && p.read_int(&mi) &&
            p.expect("Q") && p.read_rows(n, &Q, &nc) && p.expect("c") &&
            p.read_rows(n, &c, &nc) && p.expect("A") &&
            p.read_rows(me, &A, &nc) && p.expect("b") &&
            p.read_rows(me, &b, &nc) && p.expect("C") &&
            p.read_rows(mi, &C, &nc) && p.expect("d") &&
            p.read_rows(mi, &d, &nc) && p.expect("x_min") &&
            p.read_rows(n, &xmin, &nc) && p.expect("x_max") &&
            p.read_rows(n, &xmax, &nc);
  if (!ok) {
    res->error = copy_str(p.error.empty() ? "parse error" : p.error);
    return res;
  }
  if (static_cast<int32_t>(Q.size()) != n * n) {
    res->error = copy_str("Q is not n x n");
    return res;
  }
  res->n = n;
  res->me = me;
  res->mi = mi;
  res->Q = copy_out(Q);
  res->c = copy_out(c);
  res->A = copy_out(A);
  res->b = copy_out(b);
  res->C = copy_out(C);
  res->d = copy_out(d);
  res->xmin = copy_out(xmin);
  res->xmax = copy_out(xmax);
  return res;
}

void jrlqp_free_ikpb(IKPbResultC* r) {
  if (!r) return;
  std::free(r->Q);
  std::free(r->c);
  std::free(r->A);
  std::free(r->b);
  std::free(r->C);
  std::free(r->d);
  std::free(r->xmin);
  std::free(r->xmax);
  std::free(r->error);
  std::free(r);
}

MatResultC* jrlqp_parse_mat(const char* text, int64_t len) {
  auto* res = static_cast<MatResultC*>(std::calloc(1, sizeof(MatResultC)));
  Lines lines(std::string_view(text, static_cast<size_t>(len)));
  std::vector<double> data, row;
  int32_t rows = 0, cols = 0;
  for (size_t i = 0; i < lines.v.size(); ++i) {
    std::string_view ln = lines.v[i];
    bool blank = true;
    for (char ch : ln)
      if (ch != ' ' && ch != '\t' && ch != '\r') { blank = false; break; }
    if (blank) continue;
    if (!parse_row(ln, &row) || row.empty()) {
      res->error = copy_str("bad number at line " + std::to_string(i + 1));
      return res;
    }
    if (rows == 0) {
      cols = static_cast<int32_t>(row.size());
    } else if (static_cast<int32_t>(row.size()) != cols) {
      res->error = copy_str("ragged matrix at line " + std::to_string(i + 1));
      return res;
    }
    data.insert(data.end(), row.begin(), row.end());
    ++rows;
  }
  res->rows = rows;
  res->cols = cols;
  res->data = copy_out(data);
  return res;
}

void jrlqp_free_mat(MatResultC* r) {
  if (!r) return;
  std::free(r->data);
  std::free(r->error);
  std::free(r);
}

}  // extern "C"
