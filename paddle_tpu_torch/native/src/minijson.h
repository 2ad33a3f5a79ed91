// Minimal JSON DOM parser for the Program IR (__model__.json).
//
// The reference deserializes ProgramDesc protobufs in C++
// (paddle/fluid/framework/program_desc.cc:96 ProgramDesc(const
// std::string&)); our IR is JSON, so the native predictor needs a JSON
// reader. Self-contained, no deps: parses the full JSON grammar (strings
// with escapes incl. \uXXXX, numbers kept as int64 when integral, nested
// arrays/objects). Errors throw std::runtime_error with byte offset.
#pragma once
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace minijson {

class Value;
using ValuePtr = std::shared_ptr<Value>;

enum class Type { Null, Bool, Int, Double, String, Array, Object };

class Value {
 public:
  Type type = Type::Null;
  bool b = false;
  int64_t i = 0;
  double d = 0.0;
  std::string s;
  std::vector<ValuePtr> arr;
  std::map<std::string, ValuePtr> obj;

  bool is_null() const { return type == Type::Null; }
  bool as_bool() const {
    if (type == Type::Bool) return b;
    if (type == Type::Int) return i != 0;
    throw std::runtime_error("json: not a bool");
  }
  int64_t as_int() const {
    if (type == Type::Int) return i;
    if (type == Type::Double && std::floor(d) == d) return (int64_t)d;
    if (type == Type::Bool) return b ? 1 : 0;
    throw std::runtime_error("json: not an int");
  }
  double as_double() const {
    if (type == Type::Double) return d;
    if (type == Type::Int) return (double)i;
    throw std::runtime_error("json: not a number");
  }
  const std::string& as_str() const {
    if (type != Type::String) throw std::runtime_error("json: not a string");
    return s;
  }
  const std::vector<ValuePtr>& as_arr() const {
    if (type != Type::Array) throw std::runtime_error("json: not an array");
    return arr;
  }
  bool has(const std::string& k) const {
    return type == Type::Object && obj.count(k) && !obj.at(k)->is_null();
  }
  const ValuePtr& at(const std::string& k) const {
    if (type != Type::Object) throw std::runtime_error("json: not an object");
    auto it = obj.find(k);
    if (it == obj.end())
      throw std::runtime_error("json: missing key '" + k + "'");
    return it->second;
  }
  // typed getters with defaults (attr access pattern)
  int64_t get_int(const std::string& k, int64_t dflt) const {
    return has(k) ? at(k)->as_int() : dflt;
  }
  double get_double(const std::string& k, double dflt) const {
    return has(k) ? at(k)->as_double() : dflt;
  }
  bool get_bool(const std::string& k, bool dflt) const {
    return has(k) ? at(k)->as_bool() : dflt;
  }
  std::string get_str(const std::string& k, const std::string& dflt) const {
    return has(k) ? at(k)->as_str() : dflt;
  }
  std::vector<int64_t> get_ints(const std::string& k) const {
    std::vector<int64_t> out;
    if (!has(k)) return out;
    for (auto& v : at(k)->as_arr()) out.push_back(v->as_int());
    return out;
  }
};

class Parser {
 public:
  explicit Parser(const std::string& text) : t_(text) {}

  ValuePtr parse() {
    ValuePtr v = value();
    ws();
    if (p_ != t_.size()) fail("trailing garbage");
    return v;
  }

 private:
  const std::string& t_;
  size_t p_ = 0;

  [[noreturn]] void fail(const std::string& msg) {
    throw std::runtime_error("json parse error at byte " +
                             std::to_string(p_) + ": " + msg);
  }
  void ws() {
    while (p_ < t_.size() && (t_[p_] == ' ' || t_[p_] == '\t' ||
                              t_[p_] == '\n' || t_[p_] == '\r'))
      ++p_;
  }
  char peek() {
    if (p_ >= t_.size()) fail("unexpected end");
    return t_[p_];
  }
  void expect(char c) {
    if (peek() != c) fail(std::string("expected '") + c + "'");
    ++p_;
  }
  bool lit(const char* s) {
    size_t n = strlen(s);
    if (t_.compare(p_, n, s) == 0) { p_ += n; return true; }
    return false;
  }

  ValuePtr value() {
    ws();
    auto v = std::make_shared<Value>();
    char c = peek();
    if (c == '{') { object(*v); return v; }
    if (c == '[') { array(*v); return v; }
    if (c == '"') { v->type = Type::String; v->s = string(); return v; }
    if (lit("null")) return v;
    if (lit("true")) { v->type = Type::Bool; v->b = true; return v; }
    if (lit("false")) { v->type = Type::Bool; v->b = false; return v; }
    number(*v);
    return v;
  }

  void object(Value& v) {
    v.type = Type::Object;
    expect('{'); ws();
    if (peek() == '}') { ++p_; return; }
    for (;;) {
      ws();
      std::string key = string();
      ws(); expect(':');
      v.obj[key] = value();
      ws();
      if (peek() == ',') { ++p_; continue; }
      expect('}');
      return;
    }
  }

  void array(Value& v) {
    v.type = Type::Array;
    expect('['); ws();
    if (peek() == ']') { ++p_; return; }
    for (;;) {
      v.arr.push_back(value());
      ws();
      if (peek() == ',') { ++p_; continue; }
      expect(']');
      return;
    }
  }

  std::string string() {
    expect('"');
    std::string out;
    for (;;) {
      if (p_ >= t_.size()) fail("unterminated string");
      char c = t_[p_++];
      if (c == '"') return out;
      if (c != '\\') { out += c; continue; }
      if (p_ >= t_.size()) fail("bad escape");
      char e = t_[p_++];
      switch (e) {
        case '"': out += '"'; break;
        case '\\': out += '\\'; break;
        case '/': out += '/'; break;
        case 'b': out += '\b'; break;
        case 'f': out += '\f'; break;
        case 'n': out += '\n'; break;
        case 'r': out += '\r'; break;
        case 't': out += '\t'; break;
        case 'u': {
          if (p_ + 4 > t_.size()) fail("bad \\u escape");
          unsigned cp = (unsigned)std::stoul(t_.substr(p_, 4), nullptr, 16);
          p_ += 4;
          // surrogate pair
          if (cp >= 0xD800 && cp <= 0xDBFF && p_ + 6 <= t_.size() &&
              t_[p_] == '\\' && t_[p_ + 1] == 'u') {
            unsigned lo = (unsigned)std::stoul(t_.substr(p_ + 2, 4),
                                               nullptr, 16);
            if (lo >= 0xDC00 && lo <= 0xDFFF) {
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              p_ += 6;
            }
          }
          // UTF-8 encode
          if (cp < 0x80) out += (char)cp;
          else if (cp < 0x800) {
            out += (char)(0xC0 | (cp >> 6));
            out += (char)(0x80 | (cp & 0x3F));
          } else if (cp < 0x10000) {
            out += (char)(0xE0 | (cp >> 12));
            out += (char)(0x80 | ((cp >> 6) & 0x3F));
            out += (char)(0x80 | (cp & 0x3F));
          } else {
            out += (char)(0xF0 | (cp >> 18));
            out += (char)(0x80 | ((cp >> 12) & 0x3F));
            out += (char)(0x80 | ((cp >> 6) & 0x3F));
            out += (char)(0x80 | (cp & 0x3F));
          }
          break;
        }
        default: fail("bad escape char");
      }
    }
  }

  void number(Value& v) {
    size_t start = p_;
    if (peek() == '-') ++p_;
    while (p_ < t_.size() && isdigit((unsigned char)t_[p_])) ++p_;
    bool integral = true;
    if (p_ < t_.size() && t_[p_] == '.') {
      integral = false;
      ++p_;
      while (p_ < t_.size() && isdigit((unsigned char)t_[p_])) ++p_;
    }
    if (p_ < t_.size() && (t_[p_] == 'e' || t_[p_] == 'E')) {
      integral = false;
      ++p_;
      if (p_ < t_.size() && (t_[p_] == '+' || t_[p_] == '-')) ++p_;
      while (p_ < t_.size() && isdigit((unsigned char)t_[p_])) ++p_;
    }
    if (p_ == start) fail("bad number");
    std::string num = t_.substr(start, p_ - start);
    if (integral) {
      try {
        v.type = Type::Int;
        v.i = std::stoll(num);
        return;
      } catch (...) { /* overflow: fall through to double */ }
    }
    v.type = Type::Double;
    v.d = std::stod(num);
  }
};

inline ValuePtr parse(const std::string& text) {
  return Parser(text).parse();
}

}  // namespace minijson
