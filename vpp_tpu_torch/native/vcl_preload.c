/* libvclshim: LD_PRELOAD session-layer admission for unmodified apps.
 *
 * Reference analog: VPP's VCL ldpreload library — an app started with
 * LD_PRELOAD=libvcl_ldpreload.so has its sockets ride VPP's host stack
 * and be filtered by the session rule tables (tests/ld_preload*, the
 * contiv-cri shim that injects that env).  Here the kernel keeps the
 * data path, and ONLY the session-layer policy decision is interposed:
 * connect()/accept()/accept4() consult the node agent's VCL admission
 * socket (hoststack/admission.py — backed by the same device-resident
 * SessionRuleEngine the VPPTCP renderer programs) before proceeding.
 *
 *   VPP_TPU_VCL_SOCK        admission socket path; unset => pass-through
 *   VPP_TPU_APPNS           app namespace index (u32, default 0)
 *   VPP_TPU_VCL_FAILCLOSED  "1" => deny when the agent is unreachable
 *                           (default: fail-open, kernel semantics keep
 *                           working while the agent restarts)
 *
 * Only AF_INET TCP/UDP is filtered; AF_UNIX etc. pass straight through
 * (which also makes the shim's own admission connection recursion-free).
 *
 * Build: compiled on demand by vpp_tpu_torch/hoststack/preload.py via the
 * same build_native() used for libpktio/libframering.
 */

#define _GNU_SOURCE
#include <arpa/inet.h>
#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

typedef int (*connect_fn)(int, const struct sockaddr *, socklen_t);
typedef int (*accept_fn)(int, struct sockaddr *, socklen_t *);
typedef int (*accept4_fn)(int, struct sockaddr *, socklen_t *, int);

static connect_fn real_connect;
static accept_fn real_accept;
static accept4_fn real_accept4;
static pthread_once_t resolve_once = PTHREAD_ONCE_INIT;

static void resolve_reals(void) {
  real_connect = (connect_fn)dlsym(RTLD_NEXT, "connect");
  real_accept = (accept_fn)dlsym(RTLD_NEXT, "accept");
  real_accept4 = (accept4_fn)dlsym(RTLD_NEXT, "accept4");
}

/* --- admission channel: one persistent fd PER THREAD --------------
 * Thread-local channels remove the process-global mutex a slow/wedged
 * agent would otherwise serialize every thread's connect()/accept()
 * behind (~4 s worst case each, in turn). Forked children get a fresh
 * channel via the pid check (a parent's stream would interleave
 * verdicts across processes). */

static __thread int chan_fd = -1;
static __thread pid_t chan_pid = 0;

/* __thread alone leaks the fd when a thread exits (no destructor) — a
 * thread-per-connection server would leak one admission fd per
 * handled connection. A pthread key's destructor closes it; the value
 * stores fd+1 so fd 0 is distinguishable from "unset". */
static pthread_key_t chan_key;
static pthread_once_t chan_key_once = PTHREAD_ONCE_INIT;

static void chan_destruct(void *p) {
  int fd = (int)(intptr_t)p - 1;
  if (fd >= 0) close(fd);
}

static void chan_key_make(void) {
  pthread_key_create(&chan_key, chan_destruct);
}

#pragma pack(push, 1)
struct vcl_req { /* must mirror hoststack/admission.py _REQ ("<BBHIIIHH") */
  uint8_t op;
  uint8_t proto;
  uint16_t pad;
  uint32_t appns;
  uint32_t lcl_ip;
  uint32_t rmt_ip;
  uint16_t lcl_port;
  uint16_t rmt_port;
};
#pragma pack(pop)

static int chan_open(void) {
  const char *path = getenv("VPP_TPU_VCL_SOCK");
  if (!path || !*path) return -1;
  int fd = socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
  if (fd < 0) return -1;
  struct sockaddr_un sa;
  memset(&sa, 0, sizeof(sa));
  sa.sun_family = AF_UNIX;
  strncpy(sa.sun_path, path, sizeof(sa.sun_path) - 1);
  /* AF_UNIX: passes straight through our own connect() interposer */
  pthread_once(&resolve_once, resolve_reals);
  if (real_connect(fd, (struct sockaddr *)&sa, sizeof(sa)) != 0) {
    close(fd);
    return -1;
  }
  /* a wedged agent (accepting but not answering) must not hang the
   * app inside connect()/accept(): bounded round trips, timeout =>
   * verdict unavailable (fail-open/-closed).
   * Worst case across query()'s one reconnect retry is ~4 s (two
   * 1 s reads; writes only stall on a full socket buffer). Post-warmup
   * verdicts are sub-ms, so 1 s only ever bites a wedged agent. */
  struct timeval tv = {1, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  return fd;
}

static int read_full(int fd, void *buf, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t r = read(fd, (char *)buf + off, n - off);
    if (r < 0 && errno == EINTR) continue; /* signal-heavy apps
        (profilers, SIGCHLD bursts) must not read as a dead peer —
        that would fail-open a policy bypass */
    if (r <= 0) return -1;
    off += (size_t)r;
  }
  return 0;
}

static int write_full(int fd, const void *buf, size_t n) {
  size_t off = 0;
  while (off < n) {
    /* MSG_NOSIGNAL: a dead agent must surface as a retry, not kill
     * the interposed app with SIGPIPE */
    ssize_t r = send(fd, (const char *)buf + off, n - off, MSG_NOSIGNAL);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return -1;
    off += (size_t)r;
  }
  return 0;
}

/* one round trip on THIS thread's channel; retries once on a dead
 * channel (agent restart). Returns 1 allow, 0 deny, -1 unavailable. */
static int query(const struct vcl_req *req) {
  int verdict = -1;
  if (chan_fd >= 0 && chan_pid != getpid()) {
    /* inherited across fork(): the fd is the PARENT's stream; using it
     * here would interleave our requests with theirs and cross their
     * verdicts. Drop it (close only our dup'd reference) — and clear
     * the pthread key too, else if the reconnect below fails this
     * thread's exit destructor close()s the stale fd number, which may
     * by then be an unrelated reused descriptor. */
    close(chan_fd);
    chan_fd = -1;
    pthread_setspecific(chan_key, NULL);
  }
  for (int attempt = 0; attempt < 2 && verdict < 0; attempt++) {
    if (chan_fd < 0) {
      chan_fd = chan_open();
      chan_pid = getpid();
      if (chan_fd >= 0) {
        pthread_once(&chan_key_once, chan_key_make);
        pthread_setspecific(chan_key, (void *)(intptr_t)(chan_fd + 1));
      }
    }
    if (chan_fd < 0) break;
    uint8_t rsp;
    if (write_full(chan_fd, req, sizeof(*req)) == 0 &&
        read_full(chan_fd, &rsp, 1) == 0) {
      verdict = rsp ? 1 : 0;
    } else {
      close(chan_fd); /* stale (agent restarted) — reconnect and retry */
      chan_fd = -1;
      pthread_setspecific(chan_key, NULL);
    }
  }
  return verdict;
}

static int fail_closed(void) {
  const char *v = getenv("VPP_TPU_VCL_FAILCLOSED");
  return v && v[0] == '1';
}

static uint32_t appns_index(void) {
  const char *v = getenv("VPP_TPU_APPNS");
  return v ? (uint32_t)strtoul(v, NULL, 10) : 0u;
}

/* proto from the socket type: SOCK_STREAM => TCP(6), SOCK_DGRAM =>
 * UDP(17); anything else is not session-layer filtered. */
static int sock_proto(int fd) {
  int type = 0;
  socklen_t len = sizeof(type);
  if (getsockopt(fd, SOL_SOCKET, SO_TYPE, &type, &len) != 0) return -1;
  if (type == SOCK_STREAM) return 6;
  if (type == SOCK_DGRAM) return 17;
  return -1;
}

/* --- interposers --------------------------------------------------- */

#ifdef __cplusplus
extern "C" {
#endif

int connect(int fd, const struct sockaddr *addr, socklen_t addrlen) {
  pthread_once(&resolve_once, resolve_reals);
  if (!addr || addr->sa_family != AF_INET ||
      !getenv("VPP_TPU_VCL_SOCK"))
    return real_connect(fd, addr, addrlen);
  int proto = sock_proto(fd);
  if (proto < 0) return real_connect(fd, addr, addrlen);

  const struct sockaddr_in *in = (const struct sockaddr_in *)addr;
  struct vcl_req req;
  memset(&req, 0, sizeof(req));
  req.op = 'C';
  req.proto = (uint8_t)proto;
  req.appns = appns_index();
  req.rmt_ip = ntohl(in->sin_addr.s_addr);
  req.rmt_port = ntohs(in->sin_port);
  /* local half: usually unbound pre-connect => wildcard zeros, same as
   * vcl.py FilteredSocket._local() */
  struct sockaddr_in lcl;
  socklen_t lcl_len = sizeof(lcl);
  if (getsockname(fd, (struct sockaddr *)&lcl, &lcl_len) == 0 &&
      lcl.sin_family == AF_INET) {
    req.lcl_ip = ntohl(lcl.sin_addr.s_addr);
    req.lcl_port = ntohs(lcl.sin_port);
  }
  int verdict = query(&req);
  if (verdict == 0 || (verdict < 0 && fail_closed())) {
    errno = ECONNREFUSED; /* policy deny: the connection never happens */
    return -1;
  }
  return real_connect(fd, addr, addrlen);
}

static int admit_accepted(int lfd, int cfd) {
  /* inbound verdict from the GLOBAL scope, per-connection local address
   * (a wildcard bind resolves on the accepted socket) */
  struct sockaddr_in lcl, rmt;
  socklen_t ll = sizeof(lcl), rl = sizeof(rmt);
  if (getsockname(cfd, (struct sockaddr *)&lcl, &ll) != 0 ||
      lcl.sin_family != AF_INET ||
      getpeername(cfd, (struct sockaddr *)&rmt, &rl) != 0)
    return 1; /* not AF_INET (or vanished) — not ours to filter */
  int proto = sock_proto(lfd);
  if (proto < 0) return 1;
  struct vcl_req req;
  memset(&req, 0, sizeof(req));
  req.op = 'A';
  req.proto = (uint8_t)proto;
  req.appns = appns_index();
  req.lcl_ip = ntohl(lcl.sin_addr.s_addr);
  req.lcl_port = ntohs(lcl.sin_port);
  req.rmt_ip = ntohl(rmt.sin_addr.s_addr);
  req.rmt_port = ntohs(rmt.sin_port);
  int verdict = query(&req);
  return !(verdict == 0 || (verdict < 0 && fail_closed()));
}

/* denied peers are closed and the accept retried — the VPP session
 * layer resets filtered sessions and the app never sees them. The
 * retry also covers non-blocking listeners: an ALLOWED peer queued
 * behind a denied one must surface on this wake (edge-triggered pollers
 * would otherwise never be re-notified for it); when the backlog is
 * truly empty real_accept itself reports EAGAIN. */
static int accept_common(int lfd, struct sockaddr *addr, socklen_t *alen,
                         int flags, int use4) {
  pthread_once(&resolve_once, resolve_reals);
  for (;;) {
    int cfd = use4 ? real_accept4(lfd, addr, alen, flags)
                   : real_accept(lfd, addr, alen);
    if (cfd < 0 || !getenv("VPP_TPU_VCL_SOCK")) return cfd;
    if (admit_accepted(lfd, cfd)) return cfd;
    close(cfd);
  }
}

int accept(int fd, struct sockaddr *addr, socklen_t *addrlen) {
  return accept_common(fd, addr, addrlen, 0, 0);
}

int accept4(int fd, struct sockaddr *addr, socklen_t *addrlen, int flags) {
  return accept_common(fd, addr, addrlen, flags, 1);
}

#ifdef __cplusplus
} /* extern "C" */
#endif
