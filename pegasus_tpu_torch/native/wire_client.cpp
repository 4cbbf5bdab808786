// Native C++ wire client for pegasus_tpu.
//
// Role parity: the reference ships native clients (src/client_lib C++,
// go-client, java-client) speaking the cluster's wire format; this is the
// pegasus_tpu equivalent — a self-contained C++17 library speaking the
// PGT1 frame + tagged value grammar (pegasus_tpu/rpc/message.py), doing
// client-side partition resolution (query_config -> crc64 routing ->
// primary dispatch, parity src/client/partition_resolver.cpp:48) with a
// C ABI so any language with FFI can bind it (the test drives it from
// ctypes against a live multi-process onebox).
//
// CRC tables re-derive from the same polynomial bit-specs as
// src/utils/crc.cpp (crc64 routing must be bit-identical everywhere).

#include <arpa/inet.h>
#include <cstdint>
#include <cstring>
#include <map>
#include <netdb.h>
#include <string>
#include <sys/socket.h>
#include <unistd.h>
#include <vector>

namespace {

// ---------------- crc (polynomial bit-specs from the reference) ----------

uint64_t crc64_table[256];
uint32_t crc32_table[256];

struct TableInit {
  TableInit() {
    static const int bits64[] = {63, 61, 59, 58, 56, 55, 52, 49, 48, 47, 46,
                                 44, 41, 37, 36, 34, 32, 31, 28, 26, 23, 22,
                                 19, 16, 13, 12, 10, 9,  6,  4,  3,  0};
    uint64_t poly64 = 0;
    for (int n : bits64) poly64 |= 1ULL << (63 - n);
    for (uint32_t i = 0; i < 256; i++) {
      uint64_t k = i;
      for (int j = 0; j < 8; j++) k = (k & 1) ? (k >> 1) ^ poly64 : k >> 1;
      crc64_table[i] = k;
    }
    static const int bits32[] = {28, 27, 26, 25, 23, 22, 20, 19, 18,
                                 14, 13, 11, 10, 9,  8,  6,  0};
    uint32_t poly32 = 0;
    for (int n : bits32) poly32 |= 1U << (31 - n);
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t k = i;
      for (int j = 0; j < 8; j++) k = (k & 1) ? (k >> 1) ^ poly32 : k >> 1;
      crc32_table[i] = k;
    }
  }
} table_init;

uint64_t crc64(const uint8_t* data, size_t n) {
  uint64_t crc = ~0ULL;
  for (size_t i = 0; i < n; i++)
    crc = crc64_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

uint32_t crc32(const uint8_t* data, size_t n) {
  uint32_t crc = ~0U;
  for (size_t i = 0; i < n; i++)
    crc = crc32_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// ---------------- tagged value grammar (rpc/message.py) -------------------

struct Value;
using ValueList = std::vector<Value>;

struct Value {
  enum Kind {
    NONE, BOOL, INT, UINT, BYTES, STR, LIST, TUPLE, DICT, DATACLASS
  } kind = NONE;
  bool b = false;
  int64_t i = 0;
  uint64_t u = 0;
  std::string s;                              // BYTES / STR payload
  std::vector<Value> items;                   // LIST / TUPLE
  std::vector<std::pair<Value, Value>> kv;    // DICT

  static Value none() { return Value{}; }
  static Value boolean(bool v) { Value x; x.kind = BOOL; x.b = v; return x; }
  static Value integer(int64_t v) { Value x; x.kind = INT; x.i = v; return x; }
  static Value uinteger(uint64_t v) {
    Value x; x.kind = UINT; x.u = v; return x;
  }
  static Value bytes(const std::string& v) {
    Value x; x.kind = BYTES; x.s = v; return x;
  }
  static Value str(const std::string& v) {
    Value x; x.kind = STR; x.s = v; return x;
  }
  // registered-dataclass value: s = registry name, items = fields in
  // the dataclass's declaration order (rpc/message.py 'D' grammar)
  static Value dataclass(const std::string& name,
                         std::vector<Value> fields) {
    Value x;
    x.kind = DATACLASS;
    x.s = name;
    x.items = std::move(fields);
    return x;
  }
  // decoded-dataclass field access (Decoder surfaces 'D' as a DICT of
  // {__dataclass__: name, 0: f0, 1: f1, ...})
  const Value* field(int64_t i) const {
    for (auto& p : kv)
      if (p.first.kind == INT && p.first.i == i) return &p.second;
    return nullptr;
  }
  bool is_dataclass(const char* name) const {
    const Value* d = get("__dataclass__");
    return d && d->kind == STR && d->s == name;
  }
  const Value* get(const std::string& key) const {
    for (auto& p : kv)
      if (p.first.kind == STR && p.first.s == key) return &p.second;
    return nullptr;
  }
  int64_t as_int() const { return kind == UINT ? (int64_t)u : i; }
};

void put_u32(std::string& out, uint32_t v) {
  char b[4];
  memcpy(b, &v, 4);  // little-endian hosts only (x86/arm LE)
  out.append(b, 4);
}

void encode(std::string& out, const Value& v) {
  switch (v.kind) {
    case Value::NONE: out += 'N'; break;
    case Value::BOOL: out += v.b ? 'T' : 'F'; break;
    case Value::INT: {
      out += 'i';
      char b[8];
      memcpy(b, &v.i, 8);
      out.append(b, 8);
      break;
    }
    case Value::UINT: {
      if (v.u <= 0x7FFFFFFFFFFFFFFFULL) {
        Value w = Value::integer((int64_t)v.u);
        encode(out, w);
      } else {
        out += 'u';
        char b[8];
        memcpy(b, &v.u, 8);
        out.append(b, 8);
      }
      break;
    }
    case Value::BYTES:
      out += 'b';
      put_u32(out, v.s.size());
      out += v.s;
      break;
    case Value::STR:
      out += 's';
      put_u32(out, v.s.size());
      out += v.s;
      break;
    case Value::LIST:
    case Value::TUPLE:
      out += v.kind == Value::LIST ? 'l' : 't';
      put_u32(out, v.items.size());
      for (auto& item : v.items) encode(out, item);
      break;
    case Value::DICT:
      out += 'm';
      put_u32(out, v.kv.size());
      for (auto& p : v.kv) {
        encode(out, p.first);
        encode(out, p.second);
      }
      break;
    case Value::DATACLASS:
      out += 'D';
      put_u32(out, v.s.size());
      out += v.s;
      put_u32(out, v.items.size());
      for (auto& item : v.items) encode(out, item);
      break;
  }
}

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  bool ok = true;

  uint32_t u32() {
    if (pos + 4 > len) { ok = false; return 0; }
    uint32_t v;
    memcpy(&v, data + pos, 4);
    pos += 4;
    return v;
  }
  Value value() {
    Value out;
    if (pos >= len) { ok = false; return out; }
    char tag = (char)data[pos++];
    switch (tag) {
      case 'N': break;
      case 'T': out = Value::boolean(true); break;
      case 'F': out = Value::boolean(false); break;
      case 'i': {
        if (pos + 8 > len) { ok = false; break; }
        int64_t v;
        memcpy(&v, data + pos, 8);
        pos += 8;
        out = Value::integer(v);
        break;
      }
      case 'u': {
        if (pos + 8 > len) { ok = false; break; }
        uint64_t v;
        memcpy(&v, data + pos, 8);
        pos += 8;
        out = Value::uinteger(v);
        break;
      }
      case 'd': {  // float: skip payload, surface as INT(0) — unused here
        pos += 8;
        break;
      }
      case 'b':
      case 's': {
        uint32_t n = u32();
        if (pos + n > len) { ok = false; break; }
        out = tag == 'b' ? Value::bytes(std::string((const char*)data + pos, n))
                         : Value::str(std::string((const char*)data + pos, n));
        pos += n;
        break;
      }
      case 'l':
      case 't': {
        uint32_t n = u32();
        out.kind = tag == 'l' ? Value::LIST : Value::TUPLE;
        for (uint32_t i = 0; i < n && ok; i++) out.items.push_back(value());
        break;
      }
      case 'm': {
        uint32_t n = u32();
        out.kind = Value::DICT;
        for (uint32_t i = 0; i < n && ok; i++) {
          Value k = value();
          Value v = value();
          out.kv.emplace_back(std::move(k), std::move(v));
        }
        break;
      }
      case 'D': {  // registered dataclass: decode as DICT of field order
        uint32_t nn = u32();
        if (pos + nn > len) { ok = false; break; }
        std::string name((const char*)data + pos, nn);
        pos += nn;
        uint32_t nf = u32();
        out.kind = Value::DICT;
        out.kv.emplace_back(Value::str("__dataclass__"), Value::str(name));
        for (uint32_t i = 0; i < nf && ok; i++) {
          Value v = value();
          out.kv.emplace_back(Value::integer(i), std::move(v));
        }
        break;
      }
      default:
        ok = false;
    }
    return out;
  }
};

// ---------------- frame ---------------------------------------------------

std::string make_frame(const std::string& src, const std::string& dst,
                       const std::string& msg_type, const Value& payload) {
  std::string body;
  encode(body, Value::str(src));
  encode(body, Value::str(dst));
  encode(body, Value::str(msg_type));
  encode(body, payload);
  std::string frame = "PGT1";
  put_u32(frame, body.size());
  put_u32(frame, crc32((const uint8_t*)body.data(), body.size()));
  frame += body;
  return frame;
}

// ---------------- client --------------------------------------------------

struct Endpoint {
  std::string host;
  int port;
};

struct Client {
  std::string name;
  std::string app_name;
  std::string user, token;
  std::map<std::string, Endpoint> book;
  std::map<std::string, int> socks;
  std::vector<std::string> metas;
  int64_t app_id = -1;
  int64_t partition_count = 0;
  std::vector<std::string> primaries;
  uint64_t next_rid = 1;
  std::string last_error;

  int sock_for(const std::string& node) {
    auto it = socks.find(node);
    if (it != socks.end()) return it->second;
    auto b = book.find(node);
    if (b == book.end()) return -1;
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(b->second.port);
    if (inet_pton(AF_INET, b->second.host.c_str(), &addr.sin_addr) != 1) {
      close(fd);
      return -1;
    }
    if (connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
      close(fd);
      return -1;
    }
    socks[node] = fd;
    return fd;
  }

  void drop_sock(const std::string& node) {
    auto it = socks.find(node);
    if (it != socks.end()) {
      close(it->second);
      socks.erase(it);
    }
  }

  bool send_msg(const std::string& node, const std::string& msg_type,
                const Value& payload) {
    int fd = sock_for(node);
    if (fd < 0) return false;
    std::string frame = make_frame(name, node, msg_type, payload);
    size_t off = 0;
    while (off < frame.size()) {
      ssize_t n = ::send(fd, frame.data() + off, frame.size() - off, 0);
      if (n <= 0) {
        drop_sock(node);
        return false;
      }
      off += (size_t)n;
    }
    return true;
  }

  // blocking read of ONE frame from the node's connection
  bool recv_msg(const std::string& node, std::string* msg_type,
                Value* payload) {
    int fd = sock_for(node);
    if (fd < 0) return false;
    auto read_exact = [&](uint8_t* buf, size_t n) -> bool {
      size_t off = 0;
      while (off < n) {
        ssize_t r = ::recv(fd, buf + off, n - off, 0);
        if (r <= 0) return false;
        off += (size_t)r;
      }
      return true;
    };
    uint8_t hdr[12];
    if (!read_exact(hdr, 12) || memcmp(hdr, "PGT1", 4) != 0) {
      drop_sock(node);
      return false;
    }
    uint32_t blen, want;
    memcpy(&blen, hdr + 4, 4);
    memcpy(&want, hdr + 8, 4);
    std::vector<uint8_t> body(blen);
    if (!read_exact(body.data(), blen) ||
        crc32(body.data(), blen) != want) {
      drop_sock(node);
      return false;
    }
    Decoder d{body.data(), body.size()};
    d.value();  // src
    d.value();  // dst
    Value mt = d.value();
    Value pl = d.value();
    if (!d.ok || mt.kind != Value::STR) return false;
    *msg_type = mt.s;
    *payload = std::move(pl);
    return true;
  }

  Value auth_value() {
    if (user.empty()) return Value::none();
    Value t;
    t.kind = Value::TUPLE;
    t.items.push_back(Value::str(user));
    t.items.push_back(Value::str(token));
    return t;
  }

  bool refresh_config() {
    for (auto& meta : metas) {
      Value req;
      req.kind = Value::DICT;
      req.kv.emplace_back(Value::str("app_name"), Value::str(app_name));
      req.kv.emplace_back(Value::str("rid"),
                          Value::integer((int64_t)next_rid++));
      if (!send_msg(meta, "query_config", req)) continue;
      std::string mt;
      Value reply;
      if (!recv_msg(meta, &mt, &reply) || mt != "query_config_reply")
        continue;
      const Value* err = reply.get("err");
      if (!err || err->as_int() != 0) {
        last_error = "query_config error";
        continue;
      }
      app_id = reply.get("app_id")->as_int();
      partition_count = reply.get("partition_count")->as_int();
      primaries.clear();
      for (auto& cfg : reply.get("configs")->items) {
        const Value* p = cfg.get("primary");
        primaries.push_back(p && p->kind == Value::STR ? p->s : "");
      }
      return true;
    }
    last_error = "no meta reachable";
    return false;
  }

  Value make_gpid(int64_t pidx) {
    Value g;
    g.kind = Value::TUPLE;
    g.items.push_back(Value::integer(app_id));
    g.items.push_back(Value::integer(pidx));
    return g;
  }

  // returns reply payload for a matching {msg_type, rid}; empty on failure
  bool call(const std::string& node, const std::string& send_type,
            Value req, const std::string& reply_type, uint64_t rid,
            Value* out) {
    if (!send_msg(node, send_type, req)) return false;
    for (int i = 0; i < 64; i++) {  // tolerate unrelated frames
      std::string mt;
      Value reply;
      if (!recv_msg(node, &mt, &reply)) return false;
      if (mt != reply_type) continue;
      const Value* r = reply.get("rid");
      if (r && (uint64_t)r->as_int() == rid) {
        *out = std::move(reply);
        return true;
      }
    }
    return false;
  }

  std::string full_key(const std::string& hk, const std::string& sk) {
    std::string key;
    key.push_back((char)((hk.size() >> 8) & 0xFF));
    key.push_back((char)(hk.size() & 0xFF));
    key += hk;
    key += sk;
    return key;
  }

  uint64_t route_hash(const std::string& hk, const std::string& sk) {
    const std::string& basis = hk.empty() ? sk : hk;
    return crc64((const uint8_t*)basis.data(), basis.size());
  }

  int write_op(const std::string& hk, const std::string& sk,
               const std::string& value, int64_t expire_ts, int op) {
    if (app_id < 0 && !refresh_config()) return -1;
    uint64_t h = route_hash(hk, sk);
    for (int attempt = 0; attempt < 4; attempt++) {
      if (attempt && !refresh_config()) return -1;
      int64_t pidx = (int64_t)(h % (uint64_t)partition_count);
      const std::string& primary = primaries[(size_t)pidx];
      if (primary.empty()) continue;
      uint64_t rid = next_rid++;
      Value wop;
      wop.kind = Value::TUPLE;
      wop.items.push_back(Value::integer(op));
      Value args;
      args.kind = Value::TUPLE;
      args.items.push_back(Value::bytes(full_key(hk, sk)));
      if (op == 1) {  // OP_PUT: (key, value, expire_ts)
        args.items.push_back(Value::bytes(value));
        args.items.push_back(Value::integer(expire_ts));
      }
      wop.items.push_back(std::move(args));
      Value ops;
      ops.kind = Value::LIST;
      ops.items.push_back(std::move(wop));
      Value req;
      req.kind = Value::DICT;
      req.kv.emplace_back(Value::str("gpid"), make_gpid(pidx));
      req.kv.emplace_back(Value::str("rid"), Value::integer((int64_t)rid));
      req.kv.emplace_back(Value::str("ops"), std::move(ops));
      req.kv.emplace_back(Value::str("auth"), auth_value());
      req.kv.emplace_back(Value::str("partition_hash"),
                          Value::uinteger(h));
      Value reply;
      if (!call(primary, "client_write", std::move(req),
                "client_write_reply", rid, &reply))
        continue;
      int64_t err = reply.get("err")->as_int();
      if (err == 0) {
        const Value* results = reply.get("results");
        if (results && !results->items.empty())
          return (int)results->items[0].as_int();
        return 0;
      }
      // retryable state errors: re-resolve; anything else surfaces
      if (err == 13 || err == 14 || err == 53 || err == 56 || err == 5 ||
          err == 6 || err == 58 || err == 63)
        continue;
      return (int)err;
    }
    last_error = "write retries exhausted";
    return -1;
  }

  // returns storage status; fills value on hit
  int read_get(const std::string& hk, const std::string& sk,
               std::string* value) {
    if (app_id < 0 && !refresh_config()) return -1;
    uint64_t h = route_hash(hk, sk);
    for (int attempt = 0; attempt < 4; attempt++) {
      if (attempt && !refresh_config()) return -1;
      int64_t pidx = (int64_t)(h % (uint64_t)partition_count);
      const std::string& primary = primaries[(size_t)pidx];
      if (primary.empty()) continue;
      uint64_t rid = next_rid++;
      Value req;
      req.kind = Value::DICT;
      req.kv.emplace_back(Value::str("gpid"), make_gpid(pidx));
      req.kv.emplace_back(Value::str("rid"), Value::integer((int64_t)rid));
      req.kv.emplace_back(Value::str("op"), Value::str("get"));
      req.kv.emplace_back(Value::str("args"),
                          Value::bytes(full_key(hk, sk)));
      req.kv.emplace_back(Value::str("auth"), auth_value());
      req.kv.emplace_back(Value::str("partition_hash"),
                          Value::uinteger(h));
      Value reply;
      if (!call(primary, "client_read", std::move(req),
                "client_read_reply", rid, &reply))
        continue;
      int64_t err = reply.get("err")->as_int();
      if (err != 0) {
        if (err == 13 || err == 14 || err == 53 || err == 56 || err == 5 ||
            err == 6 || err == 58 || err == 63)
          continue;
        return (int)err;
      }
      const Value* result = reply.get("result");
      if (!result || result->items.size() < 2) return -1;
      int status = (int)result->items[0].as_int();
      if (status == 0) *value = result->items[1].s;
      return status;
    }
    last_error = "read retries exhausted";
    return -1;
  }

  // ---- generic routed calls (retry + refresh-on-stale, the same
  // discipline as write_op/read_get) ----------------------------------

  static bool retryable(int64_t err) {
    // 58/63: replica quarantined over storage corruption — the
    // refresh-and-retry lands on the healed primary post-cure
    return err == 13 || err == 14 || err == 53 || err == 56 || err == 5 ||
           err == 6 || err == 58 || err == 63;
  }

  // op result into *result; returns 0 ok, >0 server error, -1 transport
  int read_call(int64_t pidx, const std::string& op, const Value& args,
                bool with_hash, uint64_t h, Value* result) {
    if (app_id < 0 && !refresh_config()) return -1;
    for (int attempt = 0; attempt < 4; attempt++) {
      if (attempt && !refresh_config()) return -1;
      int64_t p =
          with_hash ? (int64_t)(h % (uint64_t)partition_count) : pidx;
      const std::string& primary = primaries[(size_t)p];
      if (primary.empty()) continue;
      uint64_t rid = next_rid++;
      Value req;
      req.kind = Value::DICT;
      req.kv.emplace_back(Value::str("gpid"), make_gpid(p));
      req.kv.emplace_back(Value::str("rid"), Value::integer((int64_t)rid));
      req.kv.emplace_back(Value::str("op"), Value::str(op));
      req.kv.emplace_back(Value::str("args"), args);
      req.kv.emplace_back(Value::str("auth"), auth_value());
      if (with_hash)
        req.kv.emplace_back(Value::str("partition_hash"),
                            Value::uinteger(h));
      else
        req.kv.emplace_back(Value::str("partition_hash"), Value::none());
      Value reply;
      if (!call(primary, "client_read", std::move(req),
                "client_read_reply", rid, &reply))
        continue;
      int64_t err = reply.get("err")->as_int();
      if (err != 0) {
        if (retryable(err)) continue;
        return (int)err;
      }
      const Value* r = reply.get("result");
      if (r) *result = *r;
      return 0;
    }
    last_error = "read retries exhausted";
    return -1;
  }

  // one-op write with a prebuilt (op_code, request-dataclass) tuple;
  // NOT retried on lost replies (atomic ops would double-apply —
  // same discipline as the Python client for cas/cam)
  int write_call(uint64_t h, int op_code, Value op_args, Value* result) {
    if (app_id < 0 && !refresh_config()) return -1;
    for (int attempt = 0; attempt < 2; attempt++) {
      if (attempt && !refresh_config()) return -1;
      int64_t pidx = (int64_t)(h % (uint64_t)partition_count);
      const std::string& primary = primaries[(size_t)pidx];
      if (primary.empty()) continue;
      uint64_t rid = next_rid++;
      Value wop;
      wop.kind = Value::TUPLE;
      wop.items.push_back(Value::integer(op_code));
      wop.items.push_back(std::move(op_args));
      Value ops;
      ops.kind = Value::LIST;
      ops.items.push_back(std::move(wop));
      Value req;
      req.kind = Value::DICT;
      req.kv.emplace_back(Value::str("gpid"), make_gpid(pidx));
      req.kv.emplace_back(Value::str("rid"), Value::integer((int64_t)rid));
      req.kv.emplace_back(Value::str("ops"), std::move(ops));
      req.kv.emplace_back(Value::str("auth"), auth_value());
      req.kv.emplace_back(Value::str("partition_hash"),
                          Value::uinteger(h));
      Value reply;
      if (!call(primary, "client_write", std::move(req),
                "client_write_reply", rid, &reply))
        return -1;  // ambiguous: do NOT auto-retry an atomic write
      int64_t err = reply.get("err")->as_int();
      if (err == 0) {
        const Value* results = reply.get("results");
        if (!results || results->items.empty()) return -1;
        *result = results->items[0];
        return 0;
      }
      if (retryable(err)) continue;
      return (int)err;
    }
    last_error = "write retries exhausted";
    return -1;
  }
};

// kvs in responses arrive either as a list of KeyValue dataclasses or
// as one columnar ScanPage (key_offs/key_blob/val_offs/val_blob);
// flatten both to (full_key, value) pairs
bool decode_kvs(const Value& kvs,
                std::vector<std::pair<std::string, std::string>>* out) {
  if (kvs.kind == Value::LIST) {
    for (auto& item : kvs.items) {
      if (item.kind != Value::DICT || !item.is_dataclass("KeyValue"))
        return false;
      const Value* k = item.field(0);
      const Value* v = item.field(1);
      if (!k) return false;
      out->emplace_back(k->s, v ? v->s : std::string());
    }
    return true;
  }
  if (kvs.kind == Value::DICT && kvs.is_dataclass("ScanPage")) {
    const Value* ko = kvs.field(0);
    const Value* kb = kvs.field(1);
    const Value* vo = kvs.field(2);
    const Value* vb = kvs.field(3);
    if (!ko || !kb || !vo || !vb) return false;
    size_t n = ko->s.size() / 4;
    if (n == 0) return true;
    n -= 1;
    auto off = [](const std::string& s, size_t i) {
      uint32_t v;
      memcpy(&v, s.data() + 4 * i, 4);
      return v;
    };
    for (size_t i = 0; i < n; i++) {
      out->emplace_back(
          kb->s.substr(off(ko->s, i), off(ko->s, i + 1) - off(ko->s, i)),
          vb->s.substr(off(vo->s, i), off(vo->s, i + 1) - off(vo->s, i)));
    }
    return true;
  }
  return false;
}

// GetScannerRequest in declaration order (server/types.py:273) — the
// wire 'D' grammar is positional, so this list must track the registry
Value make_scanner_request(const std::string& start_key,
                           const std::string& stop_key,
                           int64_t batch_size) {
  std::vector<Value> f;
  f.push_back(Value::bytes(start_key));         // start_key
  f.push_back(Value::bytes(stop_key));          // stop_key
  f.push_back(Value::boolean(true));            // start_inclusive
  f.push_back(Value::boolean(false));           // stop_inclusive
  f.push_back(Value::integer(batch_size));      // batch_size
  f.push_back(Value::boolean(false));           // no_value
  f.push_back(Value::integer(0));               // hash_key_filter_type
  f.push_back(Value::bytes(""));                // hash_key_filter_pattern
  f.push_back(Value::integer(0));               // sort_key_filter_type
  f.push_back(Value::bytes(""));                // sort_key_filter_pattern
  f.push_back(Value::boolean(false));           // validate_partition_hash
  f.push_back(Value::boolean(false));           // return_expire_ts
  f.push_back(Value::boolean(false));           // full_scan
  f.push_back(Value::boolean(false));           // only_return_count
  f.push_back(Value::boolean(false));           // one_page
  return Value::dataclass("GetScannerRequest", std::move(f));
}

// Hashkey scanner: pages through [generate_key(hk, ""), next(hk))
// exactly like the Python ClusterScanner (cluster_client.py:540-586),
// including the context-expired restart past the last served key.
struct Scanner {
  Client* c;
  int64_t pidx;
  std::string start_key, stop_key;
  int64_t batch_size;
  int64_t context_id = INT64_MIN;  // INT64_MIN = no context yet
  std::string last_key;
  std::vector<std::pair<std::string, std::string>> buffer;
  size_t pos = 0;
  bool done = false;
  bool completed = false;  // server said COMPLETED: never restart
  int error = 0;

  bool fetch() {
    while (!done) {
      if (completed) {
        done = true;
        return false;
      }
      Value result;
      int rc;
      if (context_id == INT64_MIN) {
        std::string sk = start_key;
        if (!last_key.empty()) sk = last_key + std::string(1, '\0');
        rc = c->read_call(pidx, "get_scanner",
                          make_scanner_request(sk, stop_key, batch_size),
                          false, 0, &result);
      } else {
        rc = c->read_call(pidx, "scan", Value::integer(context_id),
                          false, 0, &result);
      }
      if (rc != 0) {
        error = rc;
        done = true;
        return false;
      }
      if (result.kind != Value::DICT ||
          !result.is_dataclass("ScanResponse")) {
        error = -1;
        done = true;
        return false;
      }
      const Value* err = result.field(0);
      const Value* kvs = result.field(1);
      const Value* ctx = result.field(2);
      if (!err || err->as_int() != 0) {
        error = err ? (int)err->as_int() : -1;
        done = true;
        return false;
      }
      int64_t new_ctx = ctx ? ctx->as_int() : -1;
      if (new_ctx == -2) {  // SCAN_CONTEXT_ID_NOT_EXIST: restart
        context_id = INT64_MIN;
        continue;
      }
      buffer.clear();
      pos = 0;
      if (kvs && !decode_kvs(*kvs, &buffer)) {
        error = -1;
        done = true;
        return false;
      }
      if (!buffer.empty()) last_key = buffer.back().first;
      if (new_ctx == -1) {
        completed = true;
      } else {
        context_id = new_ctx;
      }
      if (!buffer.empty()) return true;
      // empty page: COMPLETED ends the scan (next loop pass), a live
      // context keeps paging
    }
    return false;
  }
};

}  // namespace

// ---------------- C ABI ---------------------------------------------------

extern "C" {

// address_book: "name=host:port;name=host:port;..."; metas: "meta0,meta1"
void* pegc_open(const char* client_name, const char* address_book,
                const char* metas, const char* app_name, const char* user,
                const char* token) {
  auto* c = new Client();
  c->name = client_name;
  c->app_name = app_name;
  if (user) c->user = user;
  if (token) c->token = token;
  std::string book(address_book);
  size_t pos = 0;
  while (pos < book.size()) {
    size_t end = book.find(';', pos);
    if (end == std::string::npos) end = book.size();
    std::string entry = book.substr(pos, end - pos);
    size_t eq = entry.find('=');
    size_t colon = entry.rfind(':');
    if (eq != std::string::npos && colon != std::string::npos && colon > eq) {
      c->book[entry.substr(0, eq)] = Endpoint{
          entry.substr(eq + 1, colon - eq - 1),
          atoi(entry.c_str() + colon + 1)};
    }
    pos = end + 1;
  }
  std::string ms(metas);
  pos = 0;
  while (pos < ms.size()) {
    size_t end = ms.find(',', pos);
    if (end == std::string::npos) end = ms.size();
    c->metas.push_back(ms.substr(pos, end - pos));
    pos = end + 1;
  }
  return c;
}

void pegc_close(void* handle) {
  auto* c = (Client*)handle;
  for (auto& p : c->socks) close(p.second);
  delete c;
}

int pegc_refresh(void* handle) {
  return ((Client*)handle)->refresh_config() ? 0 : -1;
}

long pegc_partition_count(void* handle) {
  return (long)((Client*)handle)->partition_count;
}

int pegc_set(void* handle, const char* hk, int hklen, const char* sk,
             int sklen, const char* value, int vlen, long expire_ts) {
  return ((Client*)handle)
      ->write_op(std::string(hk, hklen), std::string(sk, sklen),
                 std::string(value, vlen), expire_ts, 1 /*OP_PUT*/);
}

int pegc_del(void* handle, const char* hk, int hklen, const char* sk,
             int sklen) {
  return ((Client*)handle)
      ->write_op(std::string(hk, hklen), std::string(sk, sklen), "", 0,
                 2 /*OP_REMOVE*/);
}

// returns status (0=OK,1=NotFound,<0 transport); on OK writes min(vlen,cap)
// bytes and stores the full length into *out_len
int pegc_get(void* handle, const char* hk, int hklen, const char* sk,
             int sklen, char* out, int out_cap, int* out_len) {
  std::string value;
  int status = ((Client*)handle)
                   ->read_get(std::string(hk, hklen),
                              std::string(sk, sklen), &value);
  if (status == 0) {
    int n = (int)value.size();
    *out_len = n;
    if (n > out_cap) n = out_cap;
    memcpy(out, value.data(), n);
  }
  return status;
}

const char* pegc_last_error(void* handle) {
  return ((Client*)handle)->last_error.c_str();
}

uint64_t pegc_crc64(const char* data, int len) {
  return crc64((const uint8_t*)data, len);
}

// ---- multi_get: all sort keys of one hash key --------------------------
// Packs results into `out` as [u32 n] then n x [u32 sk_len][sk]
// [u32 v_len][v] (sort keys decomposed from the full keys). Returns the
// storage status, or -2 when the packed blob exceeds out_cap (caller
// retries with a bigger buffer; *out_len carries the needed size).
int pegc_multi_get(void* handle, const char* hk, int hklen, char* out,
                   long out_cap, long* out_len) {
  auto* c = (Client*)handle;
  std::string hash_key(hk, hklen);
  uint64_t h = c->route_hash(hash_key, "");
  std::vector<std::pair<std::string, std::string>> rows;
  std::string start_sortkey;
  // the server's one-shot range-read budget returns INCOMPLETE with a
  // resume sort key — page until the range is exhausted, exactly like
  // the Python client's paginate_sortkeys driver
  for (int page = 0; page < 1 << 20; page++) {
    // MultiGetRequest in declaration order (server/types.py:160)
    std::vector<Value> f;
    f.push_back(Value::bytes(hash_key));   // hash_key
    Value empty_list;
    empty_list.kind = Value::LIST;
    f.push_back(empty_list);               // sort_keys (all)
    f.push_back(Value::integer(-1));       // max_kv_count
    f.push_back(Value::integer(-1));       // max_kv_size
    f.push_back(Value::boolean(false));    // no_value
    f.push_back(Value::bytes(start_sortkey));
    f.push_back(Value::bytes(""));         // stop_sortkey
    f.push_back(Value::boolean(true));     // start_inclusive
    f.push_back(Value::boolean(false));    // stop_inclusive
    f.push_back(Value::integer(0));        // sort_key_filter_type
    f.push_back(Value::bytes(""));         // sort_key_filter_pattern
    f.push_back(Value::boolean(false));    // reverse
    Value result;
    int rc = c->read_call(
        0, "multi_get",
        Value::dataclass("MultiGetRequest", std::move(f)), true, h,
        &result);
    if (rc != 0) return rc;
    if (result.kind != Value::DICT ||
        !result.is_dataclass("MultiGetResponse"))
      return -1;
    const Value* err = result.field(0);
    if (!err) return -1;
    int64_t status = err->as_int();
    if (status != 0 && status != 7 /*INCOMPLETE*/) return (int)status;
    const Value* kvs = result.field(1);
    if (kvs && !decode_kvs(*kvs, &rows)) return -1;
    if (status == 0) break;
    const Value* resume = result.field(2);
    if (!resume || resume->kind == Value::NONE) break;
    start_sortkey = resume->s;
  }
  std::string blob;
  put_u32(blob, rows.size());
  for (auto& r : rows) {
    // multi_get kvs carry the SORT KEY in KeyValue.key already
    put_u32(blob, r.first.size());
    blob += r.first;
    put_u32(blob, r.second.size());
    blob += r.second;
  }
  *out_len = (long)blob.size();
  if ((long)blob.size() > out_cap) return -2;
  memcpy(out, blob.data(), blob.size());
  return 0;
}

// ---- scanner: hashkey range scan with paging ---------------------------
void* pegc_scan_open(void* handle, const char* hk, int hklen,
                     long batch_size) {
  auto* c = (Client*)handle;
  if (c->app_id < 0 && !c->refresh_config()) return nullptr;
  std::string hash_key(hk, hklen);
  auto* s = new Scanner();
  s->c = c;
  s->batch_size = batch_size > 0 ? batch_size : 100;
  s->start_key = c->full_key(hash_key, "");
  // adjacent successor of every key with this hashkey prefix
  // (key_schema.generate_next_bytes): drop trailing 0xFF, bump last
  std::string buf = s->start_key;
  int i = (int)buf.size() - 1;
  while (i >= 0 && (uint8_t)buf[i] == 0xFF) i--;
  if (i < 0) {
    s->stop_key = "";  // unbounded
  } else {
    buf[i] = (char)((uint8_t)buf[i] + 1);
    s->stop_key = buf.substr(0, i + 1);
  }
  uint64_t h = c->route_hash(hash_key, "");
  s->pidx = (int64_t)(h % (uint64_t)c->partition_count);
  return s;
}

// 0 = row produced (sort key + value written, lengths via out params,
// truncated at the caps), 1 = exhausted, <0 / >1 = error status
// -3 = a buffer is too small: *sk_len / *v_len carry the needed sizes
// and the row is NOT consumed — the caller re-calls with bigger buffers
int pegc_scan_next(void* scanner, char* sk_out, int sk_cap, int* sk_len,
                   char* v_out, int v_cap, int* v_len) {
  auto* s = (Scanner*)scanner;
  while (true) {
    if (s->pos < s->buffer.size()) {
      auto& row = s->buffer[s->pos];
      // full key = [u16 BE hklen][hashkey][sortkey]
      if (row.first.size() < 2) {
        s->pos++;
        return -1;
      }
      int hkl = ((uint8_t)row.first[0] << 8) | (uint8_t)row.first[1];
      std::string sk = row.first.substr(2 + hkl);
      *sk_len = (int)sk.size();
      *v_len = (int)row.second.size();
      if ((int)sk.size() > sk_cap || (int)row.second.size() > v_cap)
        return -3;
      s->pos++;
      memcpy(sk_out, sk.data(), sk.size());
      memcpy(v_out, row.second.data(), row.second.size());
      return 0;
    }
    if (s->done || !s->fetch()) return s->error ? s->error : 1;
  }
}

void pegc_scan_close(void* scanner) {
  auto* s = (Scanner*)scanner;
  if (s->context_id != INT64_MIN && !s->completed && !s->done) {
    Value result;  // best-effort context release
    s->c->read_call(s->pidx, "clear_scanner",
                    Value::integer(s->context_id), false, 0, &result);
  }
  delete s;
}

// ---- check_and_set / check_and_mutate ----------------------------------
// Returns the storage status; *check_exist reports whether the checked
// value existed (meaningful when return_check_value was requested).
int pegc_check_and_set(void* handle, const char* hk, int hklen,
                       const char* check_sk, int check_sklen,
                       int check_type, const char* operand, int operand_len,
                       const char* set_sk, int set_sklen,
                       const char* set_value, int set_vlen,
                       long ttl_seconds, int* check_exist) {
  auto* c = (Client*)handle;
  std::string hash_key(hk, hklen);
  std::string csk(check_sk, check_sklen);
  std::string ssk(set_sk, set_sklen);
  // CheckAndSetRequest in declaration order (server/types.py:224)
  std::vector<Value> f;
  f.push_back(Value::bytes(hash_key));
  f.push_back(Value::bytes(csk));
  f.push_back(Value::integer(check_type));
  f.push_back(Value::bytes(std::string(operand, operand_len)));
  f.push_back(Value::boolean(csk != ssk));       // set_diff_sort_key
  f.push_back(Value::bytes(ssk));
  f.push_back(Value::bytes(std::string(set_value, set_vlen)));
  f.push_back(Value::integer(ttl_seconds));      // set_expire_ts_seconds
  f.push_back(Value::boolean(true));             // return_check_value
  Value result;
  int rc = c->write_call(
      c->route_hash(hash_key, ""), 6 /*OP_CAS*/,
      Value::dataclass("CheckAndSetRequest", std::move(f)), &result);
  if (rc != 0) return rc;
  if (result.kind == Value::INT || result.kind == Value::UINT)
    return (int)result.as_int();  // per-op status (gate deny/throttle)
  if (result.kind != Value::DICT ||
      !result.is_dataclass("CheckAndSetResponse"))
    return -1;
  const Value* err = result.field(0);
  const Value* exist = result.field(2);
  if (check_exist) *check_exist = exist && exist->b ? 1 : 0;
  return err ? (int)err->as_int() : -1;
}

// One-mutate check_and_mutate: mutate_op 0 = SET, 1 = DELETE
// (MutateOperation, server/types.py:45).
int pegc_check_and_mutate(void* handle, const char* hk, int hklen,
                          const char* check_sk, int check_sklen,
                          int check_type, const char* operand,
                          int operand_len, int mutate_op,
                          const char* m_sk, int m_sklen,
                          const char* m_value, int m_vlen,
                          int* check_exist) {
  auto* c = (Client*)handle;
  std::string hash_key(hk, hklen);
  // Mutate in declaration order (server/types.py:246)
  std::vector<Value> mf;
  mf.push_back(Value::integer(mutate_op));
  mf.push_back(Value::bytes(std::string(m_sk, m_sklen)));
  mf.push_back(Value::bytes(std::string(m_value, m_vlen)));
  mf.push_back(Value::integer(0));
  Value mutates;
  mutates.kind = Value::LIST;
  mutates.items.push_back(Value::dataclass("Mutate", std::move(mf)));
  // CheckAndMutateRequest in declaration order (server/types.py:254)
  std::vector<Value> f;
  f.push_back(Value::bytes(hash_key));
  f.push_back(Value::bytes(std::string(check_sk, check_sklen)));
  f.push_back(Value::integer(check_type));
  f.push_back(Value::bytes(std::string(operand, operand_len)));
  f.push_back(std::move(mutates));
  f.push_back(Value::boolean(true));             // return_check_value
  Value result;
  int rc = c->write_call(
      c->route_hash(hash_key, ""), 7 /*OP_CAM*/,
      Value::dataclass("CheckAndMutateRequest", std::move(f)), &result);
  if (rc != 0) return rc;
  if (result.kind == Value::INT || result.kind == Value::UINT)
    return (int)result.as_int();  // per-op status (gate deny/throttle)
  if (result.kind != Value::DICT ||
      !result.is_dataclass("CheckAndMutateResponse"))
    return -1;
  const Value* err = result.field(0);
  const Value* exist = result.field(2);
  if (check_exist) *check_exist = exist && exist->b ? 1 : 0;
  return err ? (int)err->as_int() : -1;
}
}
