// Native FlatZinc frontend: single-pass lexer + item parser.
//
// The reference's frontend is a C++ parser (lala-parsing's
// parse_flatzinc, used at common_solving.hpp:404-417). This is our
// native counterpart: it scans the whole .fzn buffer once and emits
// flat arrays (interned names, variable/array/constraint tables) that
// the Python layer turns into its Model AST without per-token Python
// work. Items the fast path does not understand are reported as
// "complex" spans and re-parsed by the Python fallback parser.
//
// Build: g++ -O2 -shared -fPIC -o libfznparser.so fzn_parser.cpp
//
// ABI: plain C, driven through ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Pool {
  std::vector<int64_t> data;  // generic int64 pool
};

// Argument encoding in the args pool (3 ints per node):
//   kind, a, b
// kind: 0=int(a), 1=ident(name_id=a), 2=range(a..b),
//       3=set(pool offset=a, len=b)      (set_pool: values)
//       4=list(pool offset=a, len=b)     (elem_pool: kind,val pairs)
//       5=access(name_id=a, index=b)
enum ArgKind { AK_INT = 0, AK_IDENT = 1, AK_RANGE = 2, AK_SET = 3,
               AK_LIST = 4, AK_ACCESS = 5 };

struct Result {
  // Interned names.
  std::string name_bytes;
  std::vector<int64_t> name_offs;  // offsets into name_bytes; +1 sentinel

  // Variable declarations.
  std::vector<int64_t> var_name;       // name id
  std::vector<int64_t> var_flags;      // 1=bool | 2=output | 4=introduced |
                                       // 8=defined | 16=has_bounds
  std::vector<int64_t> var_lb, var_ub;
  std::vector<int64_t> var_sparse_off, var_sparse_len;  // into sparse pool
  std::vector<int64_t> sparse_pool;
  std::vector<int64_t> var_alias_kind;  // 0=none,1=int,2=ident
  std::vector<int64_t> var_alias_val;

  // Array declarations.
  std::vector<int64_t> arr_name;
  std::vector<int64_t> arr_flags;      // 1=bool | 2=is_var | 4=has_output_dims
  std::vector<int64_t> arr_lo, arr_hi; // index range
  std::vector<int64_t> arr_type_lb, arr_type_ub, arr_type_has; // elem type
  std::vector<int64_t> arr_dims_off, arr_dims_len;  // into dims pool (lo,hi)*
  std::vector<int64_t> dims_pool;
  std::vector<int64_t> arr_elem_off, arr_elem_len;  // into elem pool
  std::vector<int64_t> elem_pool;      // (kind, val) pairs: 0=int,1=ident

  // Constraints.
  std::vector<int64_t> con_name;
  std::vector<int64_t> con_arg_off, con_arg_len;  // into arg node pool
  std::vector<int64_t> con_defines;    // name id or -1
  std::vector<int64_t> arg_nodes;      // 3 ints per node
  std::vector<int64_t> set_pool;

  // Items needing the Python fallback (byte spans), incl. the solve item.
  std::vector<int64_t> complex_spans;  // (start, end) pairs

  std::string error;
};

struct Lexer {
  const char* buf;
  int64_t n;
  int64_t pos = 0;

  void skip_ws() {
    while (pos < n) {
      char c = buf[pos];
      if (c == '%') {
        while (pos < n && buf[pos] != '\n') pos++;
      } else if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
        pos++;
      } else {
        break;
      }
    }
  }
  bool eof() { skip_ws(); return pos >= n; }
  char peek() { skip_ws(); return pos < n ? buf[pos] : '\0'; }
  bool eat(char c) {
    if (peek() == c) { pos++; return true; }
    return false;
  }
  bool eat2(const char* s) {  // two-char token
    skip_ws();
    if (pos + 1 < n && buf[pos] == s[0] && buf[pos + 1] == s[1]) {
      pos += 2;
      return true;
    }
    return false;
  }
  bool peek2(const char* s) {
    skip_ws();
    return pos + 1 < n && buf[pos] == s[0] && buf[pos + 1] == s[1];
  }
  bool at_int() {
    char c = peek();
    return (c >= '0' && c <= '9') || c == '-';
  }
  bool read_int(int64_t* out) {
    skip_ws();
    int64_t p = pos;
    bool neg = false;
    if (p < n && buf[p] == '-') { neg = true; p++; }
    if (p >= n || buf[p] < '0' || buf[p] > '9') return false;
    int64_t v = 0;
    while (p < n && buf[p] >= '0' && buf[p] <= '9') {
      v = v * 10 + (buf[p] - '0');
      p++;
    }
    pos = p;
    *out = neg ? -v : v;
    return true;
  }
  bool at_ident() {
    char c = peek();
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || c == '_';
  }
  bool read_ident(int64_t* off, int64_t* len) {
    skip_ws();
    if (!at_ident()) return false;
    int64_t p = pos;
    while (p < n) {
      char c = buf[p];
      if ((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
          (c >= '0' && c <= '9') || c == '_') {
        p++;
      } else {
        break;
      }
    }
    *off = pos;
    *len = p - pos;
    pos = p;
    return true;
  }
  // Advance to just past the next ';' (item recovery).
  int64_t skip_to_semi() {
    while (pos < n && buf[pos] != ';') {
      if (buf[pos] == '%') { while (pos < n && buf[pos] != '\n') pos++; }
      else pos++;
    }
    int64_t end = pos;
    if (pos < n) pos++;  // eat ';'
    return end;
  }
};

struct Parser {
  Lexer lx;
  Result* r;
  std::unordered_map<std::string, int64_t> interned;

  int64_t intern(int64_t off, int64_t len) {
    std::string s(lx.buf + off, (size_t)len);
    auto it = interned.find(s);
    if (it != interned.end()) return it->second;
    int64_t id = (int64_t)r->name_offs.size() - 1;
    r->name_offs.back() = (int64_t)r->name_bytes.size();
    r->name_bytes.append(s);
    r->name_offs.push_back((int64_t)r->name_bytes.size());
    interned.emplace(std::move(s), id);
    return id;
  }

  bool ident_is(int64_t off, int64_t len, const char* kw) {
    return (int64_t)strlen(kw) == len && strncmp(lx.buf + off, kw, (size_t)len) == 0;
  }

  // Parse a scalar arg element used inside lists: int | ident | ident[i]
  // | true/false. Returns false if unsupported.
  bool parse_elem(int64_t* kind, int64_t* val) {
    if (lx.at_int()) {
      int64_t v;
      if (!lx.read_int(&v)) return false;
      // ranges inside lists are not expected
      if (lx.peek2("..")) return false;
      *kind = 0; *val = v;
      return true;
    }
    int64_t off, len;
    if (!lx.read_ident(&off, &len)) return false;
    if (ident_is(off, len, "true")) { *kind = 0; *val = 1; return true; }
    if (ident_is(off, len, "false")) { *kind = 0; *val = 0; return true; }
    if (lx.peek() == '[') {
      // access used inside a list -> treat as unsupported (rare)
      return false;
    }
    *kind = 1; *val = intern(off, len);
    return true;
  }

  // Parse one constraint argument into the arg node pool; returns node
  // index or -1 on unsupported construct.
  int64_t parse_arg() {
    if (lx.peek() == '[') {
      lx.eat('[');
      int64_t start = (int64_t)r->elem_pool.size();
      if (!lx.eat(']')) {
        while (true) {
          int64_t k, v;
          if (!parse_elem(&k, &v)) return -1;
          r->elem_pool.push_back(k);
          r->elem_pool.push_back(v);
          if (lx.eat(',')) continue;
          if (lx.eat(']')) break;
          return -1;
        }
      }
      int64_t node = (int64_t)r->arg_nodes.size() / 3;
      r->arg_nodes.push_back(AK_LIST);
      r->arg_nodes.push_back(start);
      r->arg_nodes.push_back(((int64_t)r->elem_pool.size() - start) / 2);
      return node;
    }
    if (lx.peek() == '{') {
      lx.eat('{');
      int64_t start = (int64_t)r->set_pool.size();
      if (!lx.eat('}')) {
        while (true) {
          int64_t v;
          if (!lx.read_int(&v)) return -1;
          r->set_pool.push_back(v);
          if (lx.eat(',')) continue;
          if (lx.eat('}')) break;
          return -1;
        }
      }
      int64_t node = (int64_t)r->arg_nodes.size() / 3;
      r->arg_nodes.push_back(AK_SET);
      r->arg_nodes.push_back(start);
      r->arg_nodes.push_back((int64_t)r->set_pool.size() - start);
      return node;
    }
    if (lx.at_int()) {
      int64_t v;
      if (!lx.read_int(&v)) return -1;
      if (lx.eat2("..")) {
        int64_t hi;
        if (!lx.read_int(&hi)) return -1;
        int64_t node = (int64_t)r->arg_nodes.size() / 3;
        r->arg_nodes.push_back(AK_RANGE);
        r->arg_nodes.push_back(v);
        r->arg_nodes.push_back(hi);
        return node;
      }
      int64_t node = (int64_t)r->arg_nodes.size() / 3;
      r->arg_nodes.push_back(AK_INT);
      r->arg_nodes.push_back(v);
      r->arg_nodes.push_back(0);
      return node;
    }
    int64_t off, len;
    if (!lx.read_ident(&off, &len)) return -1;
    if (ident_is(off, len, "true") || ident_is(off, len, "false")) {
      int64_t node = (int64_t)r->arg_nodes.size() / 3;
      r->arg_nodes.push_back(AK_INT);
      r->arg_nodes.push_back(ident_is(off, len, "true") ? 1 : 0);
      r->arg_nodes.push_back(0);
      return node;
    }
    if (lx.peek() == '[') {
      lx.eat('[');
      int64_t idx;
      if (!lx.read_int(&idx)) return -1;
      if (!lx.eat(']')) return -1;
      int64_t node = (int64_t)r->arg_nodes.size() / 3;
      r->arg_nodes.push_back(AK_ACCESS);
      r->arg_nodes.push_back(intern(off, len));
      r->arg_nodes.push_back(idx);
      return node;
    }
    if (lx.peek() == '(') return -1;  // nested call -> Python fallback
    int64_t node = (int64_t)r->arg_nodes.size() / 3;
    r->arg_nodes.push_back(AK_IDENT);
    r->arg_nodes.push_back(intern(off, len));
    r->arg_nodes.push_back(0);
    return node;
  }

  // ann ::= ident | ident(...) ; returns flags / defines info
  // Returns false on unsupported annotation payload.
  bool parse_var_annotations(int64_t* flags, int64_t* defines) {
    while (lx.peek2("::")) {
      lx.eat2("::");
      int64_t off, len;
      if (!lx.read_ident(&off, &len)) return false;
      if (ident_is(off, len, "output_var")) *flags |= 2;
      else if (ident_is(off, len, "var_is_introduced")) *flags |= 4;
      else if (ident_is(off, len, "is_defined_var")) *flags |= 8;
      else if (lx.peek() == '(') {
        // defines_var(x) or output_array([..]) or other call
        if (ident_is(off, len, "defines_var") && defines != nullptr) {
          lx.eat('(');
          int64_t doff, dlen;
          if (!lx.read_ident(&doff, &dlen)) return false;
          *defines = intern(doff, dlen);
          if (!lx.eat(')')) return false;
        } else {
          return false;  // caller handles (e.g. output_array) or fallback
        }
      }
      // bare unknown annotations are ignored
    }
    return true;
  }

  // type ::= bool | int | l..u | {a,b,...}
  // kind out: flags bits + bounds/sparse
  bool parse_type(int64_t* flags, int64_t* lb, int64_t* ub,
                  int64_t* sp_off, int64_t* sp_len) {
    *sp_off = -1; *sp_len = 0;
    if (lx.at_ident()) {
      int64_t off, len;
      lx.read_ident(&off, &len);
      if (ident_is(off, len, "bool")) {
        *flags |= 1 | 16; *lb = 0; *ub = 1;
        return true;
      }
      if (ident_is(off, len, "int")) return true;  // unbounded
      return false;  // 'set' or other -> fallback
    }
    if (lx.peek() == '{') {
      lx.eat('{');
      int64_t start = (int64_t)r->sparse_pool.size();
      int64_t mn = INT64_MAX, mx = INT64_MIN;
      while (true) {
        int64_t v;
        if (!lx.read_int(&v)) return false;
        r->sparse_pool.push_back(v);
        if (v < mn) mn = v;
        if (v > mx) mx = v;
        if (lx.eat(',')) continue;
        if (lx.eat('}')) break;
        return false;
      }
      *flags |= 16;
      *lb = mn; *ub = mx;
      *sp_off = start;
      *sp_len = (int64_t)r->sparse_pool.size() - start;
      return true;
    }
    int64_t lo, hi;
    if (!lx.read_int(&lo)) return false;
    if (!lx.eat2("..")) return false;
    if (!lx.read_int(&hi)) return false;
    *flags |= 16; *lb = lo; *ub = hi;
    return true;
  }

  void parse() {
    while (!lx.eof()) {
      int64_t item_start = lx.pos;
      if (!parse_item()) {
        // Fallback: record the span for Python.
        lx.pos = item_start;
        int64_t end = lx.skip_to_semi();
        r->complex_spans.push_back(item_start);
        r->complex_spans.push_back(end);
      }
    }
  }

  bool parse_item() {
    int64_t off, len;
    if (!lx.read_ident(&off, &len)) return false;
    if (ident_is(off, len, "constraint")) return parse_constraint();
    if (ident_is(off, len, "var")) return parse_var();
    if (ident_is(off, len, "array")) return parse_array();
    if (ident_is(off, len, "predicate")) { lx.skip_to_semi(); return true; }
    // solve / par decls -> Python fallback
    return false;
  }

  bool parse_constraint() {
    int64_t off, len;
    if (!lx.read_ident(&off, &len)) return false;
    int64_t cname = intern(off, len);
    if (!lx.eat('(')) return false;
    int64_t arg_start = (int64_t)r->con_arg_off.size();
    std::vector<int64_t> nodes;
    if (!lx.eat(')')) {
      while (true) {
        int64_t node = parse_arg();
        if (node < 0) return false;
        nodes.push_back(node);
        if (lx.eat(',')) continue;
        if (lx.eat(')')) break;
        return false;
      }
    }
    (void)arg_start;
    int64_t defines = -1;
    int64_t dummy_flags = 0;
    if (!parse_var_annotations(&dummy_flags, &defines)) return false;
    if (!lx.eat(';')) return false;
    r->con_name.push_back(cname);
    // Argument node ids are consecutive only per-arg; store the id list
    // in the elem pool as (kind=2 marker not needed): store node ids.
    r->con_arg_off.push_back((int64_t)r->elem_pool.size());
    for (int64_t nd : nodes) {
      r->elem_pool.push_back(2);  // kind tag 2 = arg-node reference
      r->elem_pool.push_back(nd);
    }
    r->con_arg_len.push_back((int64_t)nodes.size());
    r->con_defines.push_back(defines);
    return true;
  }

  bool parse_var() {
    int64_t flags = 0, lb = 0, ub = 0, sp_off = -1, sp_len = 0;
    if (!parse_type(&flags, &lb, &ub, &sp_off, &sp_len)) return false;
    if (!lx.eat(':')) return false;
    int64_t off, len;
    if (!lx.read_ident(&off, &len)) return false;
    int64_t name = intern(off, len);
    int64_t defines = -1;
    if (!parse_var_annotations(&flags, &defines)) return false;
    int64_t alias_kind = 0, alias_val = 0;
    if (lx.eat('=')) {
      if (lx.at_int()) {
        if (!lx.read_int(&alias_val)) return false;
        alias_kind = 1;
      } else {
        int64_t aoff, alen;
        if (!lx.read_ident(&aoff, &alen)) return false;
        if (ident_is(aoff, alen, "true")) { alias_kind = 1; alias_val = 1; }
        else if (ident_is(aoff, alen, "false")) { alias_kind = 1; alias_val = 0; }
        else { alias_kind = 2; alias_val = intern(aoff, alen); }
      }
    }
    if (!lx.eat(';')) return false;
    r->var_name.push_back(name);
    r->var_flags.push_back(flags);
    r->var_lb.push_back(lb);
    r->var_ub.push_back(ub);
    r->var_sparse_off.push_back(sp_off);
    r->var_sparse_len.push_back(sp_len);
    r->var_alias_kind.push_back(alias_kind);
    r->var_alias_val.push_back(alias_val);
    return true;
  }

  bool parse_array() {
    if (!lx.eat('[')) return false;
    int64_t lo, hi;
    if (!lx.read_int(&lo)) return false;
    if (!lx.eat2("..")) return false;
    if (!lx.read_int(&hi)) return false;
    if (!lx.eat(']')) return false;
    int64_t off, len;
    if (!lx.read_ident(&off, &len) || !ident_is(off, len, "of")) return false;
    int64_t flags = 0;
    {
      int64_t save = lx.pos;
      int64_t o2, l2;
      if (lx.read_ident(&o2, &l2) && ident_is(o2, l2, "var")) {
        flags |= 2;
      } else {
        lx.pos = save;
      }
    }
    int64_t tflags = 0, tlb = 0, tub = 0, sp_off = -1, sp_len = 0;
    if (!parse_type(&tflags, &tlb, &tub, &sp_off, &sp_len)) return false;
    if (tflags & 1) flags |= 1;
    if (!lx.eat(':')) return false;
    int64_t noff, nlen;
    if (!lx.read_ident(&noff, &nlen)) return false;
    int64_t name = intern(noff, nlen);
    // annotations (output_array specially)
    int64_t dims_off = -1, dims_len = 0;
    while (lx.peek2("::")) {
      lx.eat2("::");
      int64_t aoff, alen;
      if (!lx.read_ident(&aoff, &alen)) return false;
      if (ident_is(aoff, alen, "output_array")) {
        if (!lx.eat('(') || !lx.eat('[')) return false;
        dims_off = (int64_t)r->dims_pool.size();
        while (true) {
          int64_t dlo, dhi;
          if (!lx.read_int(&dlo)) return false;
          if (!lx.eat2("..")) return false;
          if (!lx.read_int(&dhi)) return false;
          r->dims_pool.push_back(dlo);
          r->dims_pool.push_back(dhi);
          dims_len++;
          if (lx.eat(',')) continue;
          if (lx.eat(']')) break;
          return false;
        }
        if (!lx.eat(')')) return false;
        flags |= 4;
      } else if (lx.peek() == '(') {
        return false;  // unknown call annotation -> fallback
      }
    }
    int64_t elem_off = (int64_t)r->elem_pool.size();
    int64_t elem_count = 0;
    if (lx.eat('=')) {
      if (!lx.eat('[')) return false;
      if (!lx.eat(']')) {
        while (true) {
          int64_t k, v;
          if (!parse_elem(&k, &v)) return false;
          r->elem_pool.push_back(k);
          r->elem_pool.push_back(v);
          elem_count++;
          if (lx.eat(',')) continue;
          if (lx.eat(']')) break;
          return false;
        }
      }
    } else {
      elem_off = -2;  // unassigned var array: Python synthesizes elements
    }
    if (!lx.eat(';')) return false;
    r->arr_name.push_back(name);
    r->arr_flags.push_back(flags);
    r->arr_lo.push_back(lo);
    r->arr_hi.push_back(hi);
    r->arr_type_lb.push_back(tlb);
    r->arr_type_ub.push_back(tub);
    r->arr_type_has.push_back((tflags & 16) ? 1 : 0);
    r->arr_dims_off.push_back(dims_off);
    r->arr_dims_len.push_back(dims_len);
    r->arr_elem_off.push_back(elem_off);
    r->arr_elem_len.push_back(elem_count);
    return true;
  }
};

}  // namespace

extern "C" {

void* fzn_parse(const char* buf, long long n) {
  auto* res = new Result();
  res->name_offs.push_back(0);
  Parser p{Lexer{buf, n}, res, {}};
  p.parse();
  return res;
}

void fzn_free(void* h) { delete static_cast<Result*>(h); }

// Accessors: return pointer + store length.
#define VEC_ACCESSOR(field)                                              \
  const int64_t* fzn_##field(void* h, long long* len) {                  \
    auto* r = static_cast<Result*>(h);                                   \
    *len = (long long)r->field.size();                                   \
    return r->field.data();                                              \
  }

VEC_ACCESSOR(name_offs)
VEC_ACCESSOR(var_name)
VEC_ACCESSOR(var_flags)
VEC_ACCESSOR(var_lb)
VEC_ACCESSOR(var_ub)
VEC_ACCESSOR(var_sparse_off)
VEC_ACCESSOR(var_sparse_len)
VEC_ACCESSOR(sparse_pool)
VEC_ACCESSOR(var_alias_kind)
VEC_ACCESSOR(var_alias_val)
VEC_ACCESSOR(arr_name)
VEC_ACCESSOR(arr_flags)
VEC_ACCESSOR(arr_lo)
VEC_ACCESSOR(arr_hi)
VEC_ACCESSOR(arr_type_lb)
VEC_ACCESSOR(arr_type_ub)
VEC_ACCESSOR(arr_type_has)
VEC_ACCESSOR(arr_dims_off)
VEC_ACCESSOR(arr_dims_len)
VEC_ACCESSOR(dims_pool)
VEC_ACCESSOR(arr_elem_off)
VEC_ACCESSOR(arr_elem_len)
VEC_ACCESSOR(elem_pool)
VEC_ACCESSOR(con_name)
VEC_ACCESSOR(con_arg_off)
VEC_ACCESSOR(con_arg_len)
VEC_ACCESSOR(con_defines)
VEC_ACCESSOR(arg_nodes)
VEC_ACCESSOR(set_pool)
VEC_ACCESSOR(complex_spans)

const char* fzn_names(void* h, long long* len) {
  auto* r = static_cast<Result*>(h);
  *len = (long long)r->name_bytes.size();
  return r->name_bytes.data();
}

}  // extern "C"
