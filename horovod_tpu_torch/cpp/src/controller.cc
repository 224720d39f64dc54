// TCP host controller: authenticated KV store + barrier service.
//
// TPU-native re-design of the reference's control plane: the reference
// rendezvouses workers through an HTTP KV store hosted by the launcher
// (horovod/runner/http/http_server.py, gloo/http_store.cc) and runs
// driver/task socket RPC with HMAC auth (runner/common/service/*.py,
// util/secret.py).  Here both roles collapse into one compact binary
// protocol:
//
//   frame  = magic 'HVDC' | u8 opcode | u32 len | payload | 32B hmac
//   hmac   = HMAC-SHA256(secret, opcode|len|payload)
//   reply  = u8 status | u32 len | payload | 32B hmac
//
// Opcodes: 1=PUT 2=GET 3=COUNT 4=DELSCOPE 5=PING.
// GET is non-blocking server-side; clients poll (the reference's HTTP
// store clients poll the same way).  Barrier = PUT barrier-scope/rank
// then poll COUNT >= world.
#include "hvd_core.h"
#include "sha256.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace hvd {
void set_error(const std::string& msg);
}

namespace {

constexpr uint8_t OP_PUT = 1, OP_GET = 2, OP_COUNT = 3, OP_DELSCOPE = 4,
                  OP_PING = 5;
constexpr uint8_t ST_OK = 0, ST_NOTFOUND = 1, ST_AUTH = 2, ST_BAD = 3;

bool send_all(int fd, const void* data, size_t n) {
  const char* p = static_cast<const char*>(data);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w; n -= (size_t)w;
  }
  return true;
}

bool recv_all(int fd, void* data, size_t n) {
  char* p = static_cast<char*>(data);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r; n -= (size_t)r;
  }
  return true;
}

void put_u32(std::string& s, uint32_t v) {
  s.push_back(char(v >> 24)); s.push_back(char(v >> 16));
  s.push_back(char(v >> 8)); s.push_back(char(v));
}
uint32_t get_u32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// payload helpers: strings are u32-length-prefixed
void put_str(std::string& s, const std::string& v) {
  put_u32(s, (uint32_t)v.size());
  s += v;
}
bool get_str(const uint8_t*& p, const uint8_t* end, std::string& out) {
  if (end - p < 4) return false;
  uint32_t n = get_u32(p); p += 4;
  if ((uint32_t)(end - p) < n) return false;
  out.assign((const char*)p, n); p += n;
  return true;
}

struct Server {
  int listen_fd = -1;
  int port = -1;
  std::string secret;
  int32_t world;
  std::atomic<bool> stopping{false};
  std::thread accept_thread;
  std::mutex mu;
  std::map<std::string, std::map<std::string, std::string>> store;
  std::vector<std::thread> conns;

  void handle_conn(int fd) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    for (;;) {
      uint8_t hdr[9];
      if (!recv_all(fd, hdr, 9)) break;
      if (memcmp(hdr, "HVDC", 4) != 0) break;
      uint8_t op = hdr[4];
      uint32_t len = get_u32(hdr + 5);
      if (len > (64u << 20)) break;  // 64MB payload cap
      std::vector<uint8_t> payload(len), mac(32);
      if (len && !recv_all(fd, payload.data(), len)) break;
      if (!recv_all(fd, mac.data(), 32)) break;
      // verify hmac over opcode|len|payload
      std::string authed;
      authed.push_back((char)op);
      put_u32(authed, len);
      authed.append((const char*)payload.data(), len);
      uint8_t want[32];
      hvd::hmac_sha256((const uint8_t*)secret.data(), secret.size(),
                       (const uint8_t*)authed.data(), authed.size(), want);
      uint8_t status = ST_OK;
      std::string out;
      if (memcmp(want, mac.data(), 32) != 0) {
        status = ST_AUTH;
      } else {
        const uint8_t* p = payload.data();
        const uint8_t* end = p + payload.size();
        std::string scope, key, val;
        switch (op) {
          case OP_PUT:
            if (get_str(p, end, scope) && get_str(p, end, key) &&
                get_str(p, end, val)) {
              std::lock_guard<std::mutex> lock(mu);
              store[scope][key] = val;
            } else status = ST_BAD;
            break;
          case OP_GET:
            if (get_str(p, end, scope) && get_str(p, end, key)) {
              std::lock_guard<std::mutex> lock(mu);
              auto s = store.find(scope);
              if (s != store.end()) {
                auto k = s->second.find(key);
                if (k != s->second.end()) out = k->second;
                else status = ST_NOTFOUND;
              } else status = ST_NOTFOUND;
            } else status = ST_BAD;
            break;
          case OP_COUNT: {
            if (get_str(p, end, scope)) {
              std::lock_guard<std::mutex> lock(mu);
              auto s = store.find(scope);
              put_u32(out, s == store.end() ? 0 : (uint32_t)s->second.size());
            } else status = ST_BAD;
            break;
          }
          case OP_DELSCOPE:
            if (get_str(p, end, scope)) {
              std::lock_guard<std::mutex> lock(mu);
              store.erase(scope);
            } else status = ST_BAD;
            break;
          case OP_PING:
            out = "pong";
            break;
          default:
            status = ST_BAD;
        }
      }
      std::string reply;
      reply.push_back((char)status);
      put_u32(reply, (uint32_t)out.size());
      reply += out;
      uint8_t rmac[32];
      hvd::hmac_sha256((const uint8_t*)secret.data(), secret.size(),
                       (const uint8_t*)reply.data(), reply.size(), rmac);
      reply.append((const char*)rmac, 32);
      if (!send_all(fd, reply.data(), reply.size())) break;
    }
    ::close(fd);
  }

  void accept_loop() {
    for (;;) {
      sockaddr_in addr;
      socklen_t alen = sizeof(addr);
      int fd = ::accept(listen_fd, (sockaddr*)&addr, &alen);
      if (fd < 0) {
        if (stopping.load()) break;
        continue;
      }
      if (stopping.load()) { ::close(fd); break; }
      conns.emplace_back([this, fd] { handle_conn(fd); });
    }
  }
};

struct Client {
  int fd = -1;
  std::string secret;
  int32_t rank;
  std::mutex mu;

  bool request(uint8_t op, const std::string& payload, uint8_t* status,
               std::string* out) {
    std::lock_guard<std::mutex> lock(mu);
    std::string frame = "HVDC";
    frame.push_back((char)op);
    put_u32(frame, (uint32_t)payload.size());
    frame += payload;
    std::string authed;
    authed.push_back((char)op);
    put_u32(authed, (uint32_t)payload.size());
    authed += payload;
    uint8_t mac[32];
    hvd::hmac_sha256((const uint8_t*)secret.data(), secret.size(),
                     (const uint8_t*)authed.data(), authed.size(), mac);
    frame.append((const char*)mac, 32);
    if (!send_all(fd, frame.data(), frame.size())) return false;
    uint8_t rhdr[5];
    if (!recv_all(fd, rhdr, 5)) return false;
    uint32_t len = get_u32(rhdr + 1);
    if (len > (64u << 20)) return false;
    std::vector<uint8_t> body(len);
    uint8_t rmac[32];
    if (len && !recv_all(fd, body.data(), len)) return false;
    if (!recv_all(fd, rmac, 32)) return false;
    std::string reply;
    reply.push_back((char)rhdr[0]);
    put_u32(reply, len);
    reply.append((const char*)body.data(), len);
    uint8_t want[32];
    hvd::hmac_sha256((const uint8_t*)secret.data(), secret.size(),
                     (const uint8_t*)reply.data(), reply.size(), want);
    if (memcmp(want, rmac, 32) != 0) return false;
    *status = rhdr[0];
    out->assign((const char*)body.data(), len);
    return true;
  }
};

}  // namespace

extern "C" {

void* hvd_ctrl_server_start(const char* bind_host, int32_t port,
                            const char* secret, int32_t world) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) { hvd::set_error("socket failed"); return nullptr; }
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  addr.sin_addr.s_addr =
      bind_host && *bind_host ? inet_addr(bind_host) : INADDR_ANY;
  if (::bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0 || ::listen(fd, 128) < 0) {
    hvd::set_error("bind/listen failed");
    ::close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, (sockaddr*)&addr, &alen);
  auto* srv = new Server();
  srv->listen_fd = fd;
  srv->port = ntohs(addr.sin_port);
  srv->secret = secret ? secret : "";
  srv->world = world;
  srv->accept_thread = std::thread([srv] { srv->accept_loop(); });
  return srv;
}

int32_t hvd_ctrl_server_port(void* p) {
  auto* srv = static_cast<Server*>(p);
  return srv ? srv->port : -1;
}

void hvd_ctrl_server_stop(void* p) {
  auto* srv = static_cast<Server*>(p);
  if (!srv) return;
  srv->stopping.store(true);
  ::shutdown(srv->listen_fd, SHUT_RDWR);
  ::close(srv->listen_fd);
  srv->accept_thread.join();
  for (auto& t : srv->conns) t.join();
  delete srv;
}

void* hvd_ctrl_client_connect(const char* host, int32_t port,
                              const char* secret, int32_t rank) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  snprintf(portstr, sizeof(portstr), "%d", port);
  if (getaddrinfo(host, portstr, &hints, &res) != 0 || !res) {
    hvd::set_error("getaddrinfo failed");
    return nullptr;
  }
  int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0 || ::connect(fd, res->ai_addr, res->ai_addrlen) < 0) {
    hvd::set_error("connect failed");
    freeaddrinfo(res);
    if (fd >= 0) ::close(fd);
    return nullptr;
  }
  freeaddrinfo(res);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* cli = new Client();
  cli->fd = fd;
  cli->secret = secret ? secret : "";
  cli->rank = rank;
  return cli;
}

void hvd_ctrl_client_close(void* p) {
  auto* cli = static_cast<Client*>(p);
  if (!cli) return;
  ::close(cli->fd);
  delete cli;
}

int32_t hvd_ctrl_put(void* p, const char* scope, const char* key,
                     const uint8_t* val, int64_t len) {
  auto* cli = static_cast<Client*>(p);
  if (!cli || !scope || !key || len < 0) return -1;
  std::string payload;
  put_str(payload, scope);
  put_str(payload, key);
  put_u32(payload, (uint32_t)len);
  payload.append((const char*)val, (size_t)len);
  uint8_t status;
  std::string out;
  if (!cli->request(OP_PUT, payload, &status, &out)) return -1;
  return status == ST_OK ? 0 : -1;
}

int64_t hvd_ctrl_get(void* p, const char* scope, const char* key, uint8_t* out,
                     int64_t cap, int64_t timeout_ms) {
  auto* cli = static_cast<Client*>(p);
  if (!cli || !scope || !key) return -1;
  std::string payload;
  put_str(payload, scope);
  put_str(payload, key);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms < 0 ? 0 : timeout_ms);
  for (;;) {
    uint8_t status;
    std::string val;
    if (!cli->request(OP_GET, payload, &status, &val)) return -1;
    if (status == ST_OK) {
      int64_t n = (int64_t)val.size();
      if (out && cap > 0) memcpy(out, val.data(), (size_t)(n < cap ? n : cap));
      return n;
    }
    if (status != ST_NOTFOUND) return -1;
    if (timeout_ms >= 0 && std::chrono::steady_clock::now() >= deadline)
      return -1;
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
}

int32_t hvd_ctrl_delete_scope(void* p, const char* scope) {
  auto* cli = static_cast<Client*>(p);
  if (!cli || !scope) return -1;
  std::string payload;
  put_str(payload, scope);
  uint8_t status;
  std::string out;
  if (!cli->request(OP_DELSCOPE, payload, &status, &out)) return -1;
  return status == ST_OK ? 0 : -1;
}

int32_t hvd_ctrl_barrier(void* p, const char* name, int32_t count,
                         int64_t timeout_ms) {
  auto* cli = static_cast<Client*>(p);
  if (!cli || !name || count <= 0) return -1;
  std::string scope = std::string("__barrier__/") + name;
  char keybuf[32];
  snprintf(keybuf, sizeof(keybuf), "%d", cli->rank);
  if (hvd_ctrl_put(p, scope.c_str(), keybuf, (const uint8_t*)"1", 1) != 0)
    return -1;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms < 0 ? 0 : timeout_ms);
  for (;;) {
    std::string payload;
    put_str(payload, scope);
    uint8_t status;
    std::string out;
    if (!cli->request(OP_COUNT, payload, &status, &out) || status != ST_OK ||
        out.size() != 4)
      return -1;
    if ((int32_t)get_u32((const uint8_t*)out.data()) >= count) return 0;
    if (timeout_ms >= 0 && std::chrono::steady_clock::now() >= deadline)
      return -1;
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
  }
}

}  // extern "C"
