// Native QPS-format parser (MPS + QUADOBJ extension).
//
// The port's copy of native/qps_parser.cpp, with the same C interface:
// host C++ of jrlqp_tpu_torch's IO layer, matching the semantics of the
// reference's test-side reader (ref: tests/QPSReader.cpp) and of the
// Python parser in jrlqp_tpu_torch/io/qps.py:
//   - ROWS: N (first objective row), E, L, G
//   - COLUMNS: (col,row,value) pairs; objective-row entries -> linear cost a
//   - RHS: objective-row RHS is the negated constant (ref QPSReader.cpp:414)
//   - RANGES: E: v>=0 widens u / v<0 lowers l; L: l=u-|v|; G: u=l+|v|
//   - BOUNDS: LO/UP/FX/FR/MI/PL/BV; default variable bounds [0, +inf)
//   - QUADOBJ: lower-triangular entries of G, mirrored to full symmetric
//
// Exposed as a C ABI for ctypes (jrlqp_tpu_torch/io/native.py builds it
// with g++ at first use).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

struct Triplet {
  int32_t i, j;
  double v;
};

enum class Section { None, Rows, Columns, Rhs, Ranges, Bounds, QuadObj };

struct Parser {
  std::unordered_map<std::string, int32_t> row_index;   // constraint rows
  std::vector<char> row_type;                            // 'E' | 'L' | 'G'
  std::unordered_map<std::string, int32_t> col_index;
  std::string obj_row;
  bool have_obj = false;

  std::vector<Triplet> c_vals, g_vals;
  std::vector<std::pair<int32_t, double>> a_vals, rhs_vals, range_vals;
  struct Bnd {
    char type[3];
    int32_t col;
    double v;
  };
  std::vector<Bnd> bnd_vals;
  double objcst = 0.0;
  std::string name;
  std::string error;
  int line_no = 0;

  int32_t col_of(std::string_view tok) {
    auto it = col_index.find(std::string(tok));
    if (it != col_index.end()) return it->second;
    int32_t id = static_cast<int32_t>(col_index.size());
    col_index.emplace(std::string(tok), id);
    return id;
  }

  bool fail(const std::string& msg) {
    error = "line " + std::to_string(line_no) + ": " + msg;
    return false;
  }
};

std::vector<std::string_view> split(std::string_view line) {
  std::vector<std::string_view> out;
  size_t i = 0;
  while (i < line.size()) {
    while (i < line.size() && (line[i] == ' ' || line[i] == '\t')) ++i;
    size_t start = i;
    while (i < line.size() && line[i] != ' ' && line[i] != '\t') ++i;
    if (i > start) out.push_back(line.substr(start, i - start));
  }
  return out;
}

std::string upper(std::string_view s) {
  std::string out(s);
  for (char& c : out) c = static_cast<char>(::toupper(static_cast<unsigned char>(c)));
  return out;
}

bool parse_double(std::string_view tok, double* out) {
  char buf[64];
  if (tok.size() >= sizeof(buf)) return false;
  std::memcpy(buf, tok.data(), tok.size());
  buf[tok.size()] = '\0';
  char* end = nullptr;
  *out = std::strtod(buf, &end);
  return end == buf + tok.size();
}

bool parse(std::string_view text, Parser& p) {
  Section section = Section::None;
  size_t pos = 0;
  while (pos <= text.size()) {
    size_t nl = text.find('\n', pos);
    std::string_view raw = text.substr(pos, nl == std::string_view::npos
                                               ? text.size() - pos
                                               : nl - pos);
    pos = (nl == std::string_view::npos) ? text.size() + 1 : nl + 1;
    ++p.line_no;
    if (!raw.empty() && raw.back() == '\r') raw.remove_suffix(1);
    // skip blank / comment lines
    size_t ns = raw.find_first_not_of(" \t");
    if (ns == std::string_view::npos || raw[ns] == '*') continue;

    bool is_header = raw[0] != ' ' && raw[0] != '\t';
    auto toks = split(raw);
    if (is_header) {
      std::string head = upper(toks[0]);
      if (head == "NAME") {
        if (toks.size() > 1) p.name = std::string(toks[1]);
      } else if (head == "ENDATA") {
        break;
      } else if (head == "ROWS") {
        section = Section::Rows;
      } else if (head == "COLUMNS") {
        section = Section::Columns;
      } else if (head == "RHS") {
        section = Section::Rhs;
      } else if (head == "RANGES") {
        section = Section::Ranges;
      } else if (head == "BOUNDS") {
        section = Section::Bounds;
      } else if (head == "QUADOBJ") {
        section = Section::QuadObj;
      } else {
        return p.fail("unknown section '" + head + "'");
      }
      continue;
    }

    switch (section) {
      case Section::Rows: {
        if (toks.size() != 2) return p.fail("bad ROWS line");
        std::string rt = upper(toks[0]);
        if (rt == "N") {
          if (p.have_obj) return p.fail("multiple N rows");
          p.obj_row = std::string(toks[1]);
          p.have_obj = true;
        } else if (rt == "E" || rt == "L" || rt == "G") {
          int32_t id = static_cast<int32_t>(p.row_index.size());
          p.row_index.emplace(std::string(toks[1]), id);
          p.row_type.push_back(rt[0]);
        } else {
          return p.fail("unknown row type '" + rt + "'");
        }
        break;
      }
      case Section::Columns: {
        if (toks.size() != 3 && toks.size() != 5)
          return p.fail("bad COLUMNS line");
        int32_t ci = p.col_of(toks[0]);
        for (size_t k = 1; k + 1 < toks.size(); k += 2) {
          double v;
          if (!parse_double(toks[k + 1], &v)) return p.fail("bad number");
          std::string rname(toks[k]);
          if (p.have_obj && rname == p.obj_row) {
            p.a_vals.push_back({ci, v});
          } else {
            auto it = p.row_index.find(rname);
            if (it == p.row_index.end())
              return p.fail("unknown row '" + rname + "'");
            p.c_vals.push_back({it->second, ci, v});
          }
        }
        break;
      }
      case Section::Rhs: {
        if (toks.size() != 3 && toks.size() != 5) return p.fail("bad RHS line");
        for (size_t k = 1; k + 1 < toks.size(); k += 2) {
          double v;
          if (!parse_double(toks[k + 1], &v)) return p.fail("bad number");
          std::string rname(toks[k]);
          if (p.have_obj && rname == p.obj_row) {
            p.objcst = -v;  // rhs on the wrong side (ref QPSReader.cpp:414)
          } else {
            auto it = p.row_index.find(rname);
            if (it == p.row_index.end())
              return p.fail("unknown row '" + rname + "'");
            p.rhs_vals.push_back({it->second, v});
          }
        }
        break;
      }
      case Section::Ranges: {
        if (toks.size() != 3 && toks.size() != 5)
          return p.fail("bad RANGES line");
        for (size_t k = 1; k + 1 < toks.size(); k += 2) {
          double v;
          if (!parse_double(toks[k + 1], &v)) return p.fail("bad number");
          auto it = p.row_index.find(std::string(toks[k]));
          if (it == p.row_index.end()) return p.fail("unknown row in RANGES");
          p.range_vals.push_back({it->second, v});
        }
        break;
      }
      case Section::Bounds: {
        std::string bt = upper(toks[0]);
        Parser::Bnd b{};
        std::strncpy(b.type, bt.c_str(), 2);
        if (bt == "FR" || bt == "MI" || bt == "PL" || bt == "BV") {
          if (toks.size() < 3) return p.fail("bad BOUNDS line");
          b.col = p.col_of(toks[2]);
          b.v = 0.0;
        } else if (bt == "LO" || bt == "UP" || bt == "FX") {
          if (toks.size() != 4) return p.fail("bad BOUNDS line");
          b.col = p.col_of(toks[2]);
          if (!parse_double(toks[3], &b.v)) return p.fail("bad number");
        } else {
          return p.fail("unknown bound type '" + bt + "'");
        }
        p.bnd_vals.push_back(b);
        break;
      }
      case Section::QuadObj: {
        if (toks.size() != 3) return p.fail("bad QUADOBJ line");
        double v;
        if (!parse_double(toks[2], &v)) return p.fail("bad number");
        p.g_vals.push_back({p.col_of(toks[0]), p.col_of(toks[1]), v});
        break;
      }
      case Section::None:
        return p.fail("data before any section");
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Dense problem arrays, all malloc'd; free with qps_free.
struct QPSResultC {
  int32_t n, m, n_eq;
  double objcst;
  double* G;   // n*n row-major
  double* a;   // n
  double* C;   // m*n row-major
  double* l;   // m
  double* u;   // m
  double* xl;  // n
  double* xu;  // n
  char* name;
  char* error;  // non-null on failure; all other pointers null
};

static char* dup_str(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

QPSResultC* qps_parse(const char* text, int64_t len) {
  auto* res = static_cast<QPSResultC*>(std::calloc(1, sizeof(QPSResultC)));
  Parser p;
  if (!parse(std::string_view(text, static_cast<size_t>(len)), p)) {
    res->error = dup_str(p.error);
    return res;
  }
  const int32_t n = static_cast<int32_t>(p.col_index.size());
  const int32_t m = static_cast<int32_t>(p.row_index.size());
  res->n = n;
  res->m = m;
  res->objcst = p.objcst;
  res->name = dup_str(p.name);
  res->G = static_cast<double*>(std::calloc(size_t(n) * n, sizeof(double)));
  res->a = static_cast<double*>(std::calloc(n, sizeof(double)));
  res->C = static_cast<double*>(std::calloc(size_t(m) * n, sizeof(double)));
  res->l = static_cast<double*>(std::calloc(m, sizeof(double)));
  res->u = static_cast<double*>(std::calloc(m, sizeof(double)));
  res->xl = static_cast<double*>(std::calloc(n, sizeof(double)));
  res->xu = static_cast<double*>(std::malloc(size_t(n) * sizeof(double)));
  for (int32_t i = 0; i < n; ++i) res->xu[i] = kInf;

  for (const auto& t : p.g_vals) {  // lower triangle mirrored
    res->G[size_t(t.i) * n + t.j] = t.v;
    res->G[size_t(t.j) * n + t.i] = t.v;
  }
  for (const auto& [i, v] : p.a_vals) res->a[i] = v;
  for (const auto& t : p.c_vals) res->C[size_t(t.i) * n + t.j] = t.v;

  int32_t n_eq = 0;
  for (int32_t i = 0; i < m; ++i) {
    switch (p.row_type[i]) {
      case 'E':
        res->l[i] = res->u[i] = 0.0;
        ++n_eq;
        break;
      case 'L':
        res->l[i] = -kInf;
        res->u[i] = 0.0;
        break;
      default:  // 'G'
        res->l[i] = 0.0;
        res->u[i] = kInf;
        break;
    }
  }
  res->n_eq = n_eq;
  for (const auto& [i, v] : p.rhs_vals) {
    switch (p.row_type[i]) {
      case 'E':
        res->l[i] = res->u[i] = v;
        break;
      case 'L':
        res->l[i] = -kInf;
        res->u[i] = v;
        break;
      default:
        res->l[i] = v;
        res->u[i] = kInf;
        break;
    }
  }
  for (const auto& [i, v] : p.range_vals) {
    switch (p.row_type[i]) {
      case 'E':
        if (v >= 0)
          res->u[i] += v;
        else
          res->l[i] += v;
        break;
      case 'L':
        res->l[i] = res->u[i] - std::fabs(v);
        break;
      default:
        res->u[i] = res->l[i] + std::fabs(v);
        break;
    }
  }
  for (const auto& b : p.bnd_vals) {
    const int32_t i = b.col;
    if (!std::strcmp(b.type, "LO")) {
      res->xl[i] = b.v;
    } else if (!std::strcmp(b.type, "UP")) {
      res->xu[i] = b.v;
    } else if (!std::strcmp(b.type, "FX")) {
      res->xl[i] = res->xu[i] = b.v;
    } else if (!std::strcmp(b.type, "FR")) {
      res->xl[i] = -kInf;
      res->xu[i] = kInf;
    } else if (!std::strcmp(b.type, "MI")) {
      res->xl[i] = -kInf;
    } else if (!std::strcmp(b.type, "PL")) {
      res->xu[i] = kInf;
    } else if (!std::strcmp(b.type, "BV")) {
      res->xl[i] = 0.0;
      res->xu[i] = 1.0;
    }
  }
  return res;
}

void qps_free(QPSResultC* res) {
  if (!res) return;
  std::free(res->G);
  std::free(res->a);
  std::free(res->C);
  std::free(res->l);
  std::free(res->u);
  std::free(res->xl);
  std::free(res->xu);
  std::free(res->name);
  std::free(res->error);
  std::free(res);
}

}  // extern "C"
