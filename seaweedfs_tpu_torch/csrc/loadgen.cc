// Minimal keep-alive HTTP load generator (benchmark client).
//
// N threads, each with one keep-alive connection, issue requests until
// a duration ends, checking status codes and timing every request. It
// measures the native plane, which a Python client cannot drive hard
// enough.
//
//   ./loadgen <host> <port> <seconds> <threads> <path-file> [post <size>]
//
// path-file: one request path a line (e.g. /3,01637037d6), optionally
// followed by a space and a payload size. GET mode: each thread cycles
// through the paths from its own offset. POST mode (`post <size>`, the
// size of lines that give none): the threads take the paths in order,
// each once, and upload a multipart body to it, ending early when every
// path is written; use a batch assign's fid, fid_1, ... so every write
// is a fresh needle. The payload of path i is pattern[o, o + size) with
// o = (i * 7919) % 4096 and pattern[j] = 'a' + (j * 2654435761 mod 2^32)
// mod 26, so a reader can rebuild every byte written.
// Prints one JSON line: requests, seconds, req/s, errors, body bytes
// (sent in POST mode, received in GET mode), MB/s, the p50 and p99
// latency in microseconds, and in POST mode the paths written (the
// first `written` of the file).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

std::atomic<uint64_t> g_requests{0}, g_errors{0}, g_bytes{0};
std::atomic<uint64_t> g_next{0};     // POST mode: the next path to write
std::atomic<int> g_active{0};        // threads still running
std::atomic<bool> g_stop{false};
std::mutex g_lat_mu;
std::vector<uint32_t> g_lat_us;      // every request's latency

int dial(const char* host, int port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in a{};
  a.sin_family = AF_INET;
  a.sin_port = htons(static_cast<uint16_t>(port));
  a.sin_addr.s_addr = inet_addr(host);
  if (connect(fd, reinterpret_cast<sockaddr*>(&a), sizeof a) != 0) {
    close(fd);
    return -1;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  return fd;
}

// Reads one HTTP response off the socket; returns status or -1, and the
// body's length in *body. Handles Content-Length framing only (both our
// planes always send it).
int read_response(int fd, std::string* buf, int64_t* body) {
  size_t header_end;
  for (;;) {
    header_end = buf->find("\r\n\r\n");
    if (header_end != std::string::npos) break;
    char tmp[8192];
    ssize_t r = recv(fd, tmp, sizeof tmp, 0);
    if (r <= 0) return -1;
    buf->append(tmp, static_cast<size_t>(r));
  }
  int status = -1;
  if (buf->size() > 12) status = atoi(buf->c_str() + 9);
  int64_t clen = 0;
  // case-insensitive content-length scan within the header block
  for (size_t pos = 0; pos < header_end;) {
    size_t eol = buf->find("\r\n", pos);
    if (eol == std::string::npos || eol > header_end) break;
    if (strncasecmp(buf->c_str() + pos, "content-length:", 15) == 0)
      clen = atoll(buf->c_str() + pos + 15);
    pos = eol + 2;
  }
  size_t need = header_end + 4 + static_cast<size_t>(clen);
  while (buf->size() < need) {
    char tmp[16384];
    ssize_t r = recv(fd, tmp, sizeof tmp, 0);
    if (r <= 0) return -1;
    buf->append(tmp, static_cast<size_t>(r));
  }
  buf->erase(0, need);
  *body = clen;
  return status;
}

// 0 = GET mode; >0 = multipart POST mode with this default size.
int g_post_size = 0;
std::string g_pattern;

struct Target {
  std::string path;
  int64_t size;
};

std::string make_post_body(uint64_t idx, int64_t size) {
  const char* b = "ldgenboundary7f3a";
  size_t off = static_cast<size_t>((idx * 7919u) % 4096u);
  return std::string("--") + b +
         "\r\nContent-Disposition: form-data; name=\"file\"; "
         "filename=\"ldgen\"\r\n"
         "Content-Type: application/octet-stream\r\n\r\n" +
         g_pattern.substr(off, static_cast<size_t>(size)) + "\r\n--" + b +
         "--\r\n";
}

void run(const char* host, int port, const std::vector<Target>* targets,
         size_t start) {
  int fd = dial(host, port);
  std::string buf;
  size_t i = start;
  std::vector<uint32_t> lat;
  while (!g_stop.load(std::memory_order_relaxed)) {
    if (fd < 0) {
      fd = dial(host, port);
      if (fd < 0) {
        g_errors++;
        usleep(10000);
        continue;
      }
      buf.clear();
    }
    std::string req;
    int64_t sent = 0;
    if (g_post_size > 0) {
      uint64_t idx = g_next.fetch_add(1);
      if (idx >= targets->size()) break;
      const Target& t = (*targets)[idx];
      std::string body = make_post_body(idx, t.size);
      sent = t.size;
      req = "POST " + t.path +
            " HTTP/1.1\r\nHost: x\r\nContent-Type: multipart/form-data; "
            "boundary=ldgenboundary7f3a\r\nContent-Length: " +
            std::to_string(body.size()) + "\r\n\r\n" + body;
    } else {
      req = "GET " + (*targets)[i++ % targets->size()].path +
            " HTTP/1.1\r\nHost: x\r\n\r\n";
    }
    auto t0 = std::chrono::steady_clock::now();
    if (send(fd, req.data(), req.size(), MSG_NOSIGNAL) !=
        static_cast<ssize_t>(req.size())) {
      close(fd);
      fd = -1;
      g_errors++;
      continue;
    }
    int64_t body = 0;
    int status = read_response(fd, &buf, &body);
    lat.push_back(static_cast<uint32_t>(
        std::chrono::duration_cast<std::chrono::microseconds>(
            std::chrono::steady_clock::now() - t0)
            .count()));
    if (status < 0) {
      close(fd);
      fd = -1;
      g_errors++;
      continue;
    }
    g_requests++;
    if (status != 200) {
      g_errors++;
    } else {
      g_bytes += g_post_size > 0 ? sent : body;
    }
  }
  if (fd >= 0) close(fd);
  {
    std::lock_guard<std::mutex> g(g_lat_mu);
    g_lat_us.insert(g_lat_us.end(), lat.begin(), lat.end());
  }
  g_active--;
}

uint32_t percentile(const std::vector<uint32_t>& sorted, double q) {
  if (sorted.empty()) return 0;
  size_t k = static_cast<size_t>(q * static_cast<double>(sorted.size() - 1));
  return sorted[k];
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 6 && !(argc == 8 && strcmp(argv[6], "post") == 0)) {
    fprintf(stderr,
            "usage: %s <host> <port> <seconds> <threads> <path-file> "
            "[post <size>]\n",
            argv[0]);
    return 2;
  }
  if (argc == 8) g_post_size = atoi(argv[7]);
  const char* host = argv[1];
  int port = atoi(argv[2]);
  double seconds = atof(argv[3]);
  int nthreads = atoi(argv[4]);
  std::vector<Target> targets;
  int64_t max_size = g_post_size;
  std::ifstream f(argv[5]);
  for (std::string line; std::getline(f, line);) {
    if (line.empty()) continue;
    std::istringstream in(line);
    Target t{"", g_post_size};
    in >> t.path;
    if (!(in >> t.size)) t.size = g_post_size;
    max_size = std::max(max_size, t.size);
    targets.push_back(t);
  }
  if (targets.empty()) {
    fprintf(stderr, "no paths\n");
    return 2;
  }
  if (g_post_size > 0) {
    g_pattern.resize(static_cast<size_t>(max_size) + 4096);
    for (size_t j = 0; j < g_pattern.size(); j++)
      g_pattern[j] = static_cast<char>(
          'a' + (static_cast<uint32_t>(j) * 2654435761u) % 26u);
  }
  auto t0 = std::chrono::steady_clock::now();
  auto deadline = t0 + std::chrono::milliseconds(
                           static_cast<int>(seconds * 1000));
  std::vector<std::thread> ts;
  g_active = nthreads;
  for (int i = 0; i < nthreads; i++)
    ts.emplace_back(run, host, port, &targets,
                    static_cast<size_t>(i) * 7919);
  while (g_active.load() > 0 && std::chrono::steady_clock::now() < deadline)
    std::this_thread::sleep_for(std::chrono::milliseconds(2));
  g_stop = true;
  for (auto& t : ts) t.join();
  double dt = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t0)
                  .count();
  std::sort(g_lat_us.begin(), g_lat_us.end());
  uint64_t written = std::min<uint64_t>(g_next.load(), targets.size());
  printf("{\"requests\": %llu, \"seconds\": %.6f, \"rps\": %.1f, "
         "\"errors\": %llu, \"bytes\": %llu, \"mb_s\": %.3f, "
         "\"p50_us\": %u, \"p99_us\": %u, \"written\": %llu}\n",
         static_cast<unsigned long long>(g_requests.load()), dt,
         g_requests.load() / dt,
         static_cast<unsigned long long>(g_errors.load()),
         static_cast<unsigned long long>(g_bytes.load()),
         g_bytes.load() / dt / 1e6, percentile(g_lat_us, 0.50),
         percentile(g_lat_us, 0.99),
         static_cast<unsigned long long>(g_post_size > 0 ? written : 0));
  return 0;
}
