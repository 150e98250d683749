// Native NPZ reader + threaded prefetch pool for the data pipeline.
//
// The port's own copy of the JAX package's native/npz_loader.cpp, NPZ only
// (the JPEG decoder there serves FedChexMimic, which is not ported yet).  The
// reference's data layer leans on torch DataLoader worker *processes* to hide
// NPZ decode latency (Dassl/dassl/data/data_manager.py:49-56).  This is a
// small C++ runtime instead: a zip/NPY parser with zlib inflate plus a
// producer-consumer thread pool that decodes ahead of the training step,
// exposed to Python over a C ABI (ctypes).  Python's zipfile+np.load pays
// interpreter overhead per member and holds the GIL; this path decodes
// entirely outside the GIL.
//
// Supported: ZIP stored (method 0) and deflate (method 8) members, NPY v1/v2
// headers, little-endian scalar dtypes.  No ZIP64 (NPZ shards in FairFedMed
// are per-sample, far below 4 GiB).  Host code: no device kernel here.

#include <zlib.h>

#include <condition_variable>
#include <cstdint>
#include <functional>
#include <cstdio>
#include <cstring>
#include <deque>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

#pragma pack(push, 1)
struct EocdRecord {
  uint32_t signature;  // 0x06054b50
  uint16_t disk, cd_disk, n_disk, n_total;
  uint32_t cd_size, cd_offset;
  uint16_t comment_len;
};
struct CdFileHeader {
  uint32_t signature;  // 0x02014b50
  uint16_t ver_made, ver_need, flags, method, mtime, mdate;
  uint32_t crc32, csize, usize;
  uint16_t name_len, extra_len, comment_len, disk, iattr;
  uint32_t eattr, local_offset;
};
struct LocalFileHeader {
  uint32_t signature;  // 0x04034b50
  uint16_t ver_need, flags, method, mtime, mdate;
  uint32_t crc32, csize, usize;
  uint16_t name_len, extra_len;
};
#pragma pack(pop)

struct Member {
  uint16_t method = 0;
  uint64_t data_offset = 0;  // resolved lazily (local header may add extras)
  uint32_t local_offset = 0;
  uint32_t csize = 0, usize = 0;
  // parsed NPY metadata
  std::string dtype;
  std::vector<int64_t> shape;
  bool fortran = false;
  uint64_t payload_offset = 0;  // offset of raw array bytes within member
  uint64_t payload_bytes = 0;
};

struct Ticket;

struct NpzFile {
  FILE* fp = nullptr;
  std::map<std::string, Member> members;
  std::vector<std::string> names;
  std::mutex io_mu;
  // decode-once cache for the stat→read call pair (guarded by io_mu)
  std::string cached_name;
  std::string cached_dtype;
  std::vector<int64_t> cached_shape;
  std::vector<uint8_t> cached_payload;
  ~NpzFile() {
    if (fp) fclose(fp);
  }
};

bool read_at(FILE* fp, uint64_t off, void* dst, size_t n) {
  if (fseeko(fp, static_cast<off_t>(off), SEEK_SET) != 0) return false;
  return fread(dst, 1, n, fp) == n;
}

// Parse the NPY header of a member's decompressed prefix. `raw` must hold at
// least the magic + header.  Fills dtype/shape/fortran/payload_offset.
bool parse_npy_header(const uint8_t* raw, size_t n, Member* m) {
  if (n < 10 || memcmp(raw, "\x93NUMPY", 6) != 0) return false;
  const uint8_t major = raw[6];
  uint64_t hlen, hoff;
  if (major == 1) {
    hlen = raw[8] | (raw[9] << 8);
    hoff = 10;
  } else {
    if (n < 12) return false;
    hlen = raw[8] | (raw[9] << 8) | (uint64_t(raw[10]) << 16) | (uint64_t(raw[11]) << 24);
    hoff = 12;
  }
  if (n < hoff + hlen) return false;
  std::string hdr(reinterpret_cast<const char*>(raw + hoff), hlen);
  // 'descr': '<f4'
  auto dpos = hdr.find("'descr'");
  if (dpos == std::string::npos) return false;
  auto q1 = hdr.find('\'', dpos + 7);
  auto q2 = hdr.find('\'', q1 + 1);
  m->dtype = hdr.substr(q1 + 1, q2 - q1 - 1);
  m->fortran = hdr.find("'fortran_order': True") != std::string::npos;
  auto spos = hdr.find("'shape'");
  auto p1 = hdr.find('(', spos);
  auto p2 = hdr.find(')', p1);
  std::string dims = hdr.substr(p1 + 1, p2 - p1 - 1);
  m->shape.clear();
  int64_t cur = -1;
  for (char c : dims) {
    if (c >= '0' && c <= '9') {
      cur = (cur < 0 ? 0 : cur) * 10 + (c - '0');
    } else if (cur >= 0) {
      m->shape.push_back(cur);
      cur = -1;
    }
  }
  if (cur >= 0) m->shape.push_back(cur);
  m->payload_offset = hoff + hlen;
  return true;
}

// Inflate a raw-deflate stream of `csize` bytes into dst (exactly dst_n).
bool inflate_raw(const uint8_t* src, size_t csize, uint8_t* dst, size_t dst_n) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = static_cast<uInt>(csize);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(dst_n);
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.total_out == dst_n;
}

// Read + decompress one member fully (thread-safe per-file via io_mu for the
// file read; decompress outside the lock).
bool load_member_bytes(NpzFile* f, Member* m, std::vector<uint8_t>* out) {
  if (m->data_offset == 0) {
    LocalFileHeader lfh;
    std::lock_guard<std::mutex> g(f->io_mu);
    if (!read_at(f->fp, m->local_offset, &lfh, sizeof(lfh))) return false;
    if (lfh.signature != 0x04034b50) return false;
    m->data_offset = m->local_offset + sizeof(LocalFileHeader) + lfh.name_len + lfh.extra_len;
  }
  std::vector<uint8_t> comp(m->csize);
  {
    std::lock_guard<std::mutex> g(f->io_mu);
    if (!read_at(f->fp, m->data_offset, comp.data(), comp.size())) return false;
  }
  out->resize(m->usize);
  if (m->method == 0) {
    if (m->csize != m->usize) return false;
    memcpy(out->data(), comp.data(), m->usize);
    return true;
  }
  if (m->method == 8) return inflate_raw(comp.data(), comp.size(), out->data(), out->size());
  return false;
}

// ---------------------------------------------------------------------------
// prefetch pool
// ---------------------------------------------------------------------------

struct Ticket {
  std::string dtype;
  std::vector<int64_t> shape;
  std::vector<uint8_t> payload;  // raw array bytes (header stripped)
  bool done = false, ok = false;
};

struct Pool {
  std::deque<std::pair<long, std::function<void(Ticket*)>>> queue;
  std::map<long, std::unique_ptr<Ticket>> tickets;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  long next_id = 1;
  bool stop = false;
  // Bounded LRU of open files.  FairFedMed stores one NPZ per sample, so an
  // unbounded FILE* cache exhausts the process fd limit (default 1024) within
  // the first epoch.  Eviction only drops the map's shared_ptr — in-flight
  // jobs captured their own reference, and the FILE* closes (~NpzFile) when
  // the last reference goes away.
  static constexpr size_t kMaxOpenFiles = 64;
  std::list<std::string> lru;  // front = most recently used
  std::map<std::string,
           std::pair<std::shared_ptr<NpzFile>, std::list<std::string>::iterator>>
      files;
  std::mutex files_mu;
};

NpzFile* open_npz(const char* path) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;
  auto f = std::make_unique<NpzFile>();
  f->fp = fp;
  if (fseeko(fp, 0, SEEK_END) != 0) return nullptr;
  uint64_t fsize = static_cast<uint64_t>(ftello(fp));
  // find EOCD: scan the last 64KiB+22 for the signature
  uint64_t scan = fsize < 65557 ? fsize : 65557;
  std::vector<uint8_t> tail(scan);
  if (!read_at(fp, fsize - scan, tail.data(), scan)) return nullptr;
  int64_t eocd_at = -1;
  for (int64_t i = static_cast<int64_t>(scan) - 22; i >= 0; --i) {
    if (tail[i] == 0x50 && tail[i + 1] == 0x4b && tail[i + 2] == 0x05 && tail[i + 3] == 0x06) {
      eocd_at = i;
      break;
    }
  }
  if (eocd_at < 0) return nullptr;
  EocdRecord eocd;
  memcpy(&eocd, tail.data() + eocd_at, sizeof(eocd));
  std::vector<uint8_t> cd(eocd.cd_size);
  if (!read_at(fp, eocd.cd_offset, cd.data(), cd.size())) return nullptr;
  size_t p = 0;
  for (uint16_t i = 0; i < eocd.n_total && p + sizeof(CdFileHeader) <= cd.size(); ++i) {
    CdFileHeader h;
    memcpy(&h, cd.data() + p, sizeof(h));
    if (h.signature != 0x02014b50) break;
    std::string name(reinterpret_cast<char*>(cd.data() + p + sizeof(h)), h.name_len);
    Member m;
    m.method = h.method;
    m.local_offset = h.local_offset;
    m.csize = h.csize;
    m.usize = h.usize;
    f->members[name] = m;
    f->names.push_back(name);
    p += sizeof(h) + h.name_len + h.extra_len + h.comment_len;
  }
  return f.release();
}

bool fetch(NpzFile* f, const std::string& member, Ticket* t) {
  auto it = f->members.find(member);
  if (it == f->members.end()) {
    // allow names without the ".npy" suffix, like np.load's NpzFile mapping
    it = f->members.find(member + ".npy");
    if (it == f->members.end()) return false;
  }
  Member& m = it->second;
  std::vector<uint8_t> bytes;
  if (!load_member_bytes(f, &m, &bytes)) return false;
  Member meta = m;
  if (!parse_npy_header(bytes.data(), bytes.size(), &meta)) return false;
  if (meta.fortran) return false;  // column-major members would be
                                   // silently transposed — reject like
                                   // unsupported dtypes
  t->dtype = meta.dtype;
  t->shape = meta.shape;
  t->payload.assign(bytes.begin() + meta.payload_offset, bytes.end());
  return true;
}


void worker_loop(Pool* pool) {
  for (;;) {
    std::function<void(Ticket*)> job;
    long id;
    {
      std::unique_lock<std::mutex> lk(pool->mu);
      pool->cv_work.wait(lk, [&] { return pool->stop || !pool->queue.empty(); });
      if (pool->stop && pool->queue.empty()) return;
      id = pool->queue.front().first;
      job = std::move(pool->queue.front().second);
      pool->queue.pop_front();
    }
    Ticket local;
    job(&local);
    {
      std::lock_guard<std::mutex> lk(pool->mu);
      auto it = pool->tickets.find(id);
      if (it != pool->tickets.end()) {  // discarded tickets drop their result
        *it->second = std::move(local);
        it->second->done = true;
      }
    }
    pool->cv_done.notify_all();
  }
}

}  // namespace

extern "C" {

// ---- single-file API ----
void* nlz_open(const char* path) { return open_npz(path); }

void nlz_close(void* h) { delete static_cast<NpzFile*>(h); }

int nlz_num_members(void* h) {
  return static_cast<int>(static_cast<NpzFile*>(h)->names.size());
}

const char* nlz_member_name(void* h, int i) {
  auto* f = static_cast<NpzFile*>(h);
  if (i < 0 || i >= static_cast<int>(f->names.size())) return nullptr;
  return f->names[i].c_str();
}

// Decodes the member ONCE, caches the payload on the handle, and returns its
// metadata; the following nlz_read for the same name copies from cache.
int nlz_member_info(void* h, const char* name, char* dtype16, int64_t* shape8,
                    int* ndim, int64_t* nbytes) {
  auto* f = static_cast<NpzFile*>(h);
  Ticket t;
  if (!fetch(f, name, &t)) return -1;
  snprintf(dtype16, 16, "%s", t.dtype.c_str());
  *ndim = static_cast<int>(t.shape.size());
  for (size_t i = 0; i < t.shape.size() && i < 8; ++i) shape8[i] = t.shape[i];
  *nbytes = static_cast<int64_t>(t.payload.size());
  std::lock_guard<std::mutex> g(f->io_mu);
  f->cached_name = name;
  f->cached_dtype = t.dtype;
  f->cached_shape = t.shape;
  f->cached_payload = std::move(t.payload);
  return 0;
}

int nlz_read(void* h, const char* name, void* dst, int64_t cap) {
  auto* f = static_cast<NpzFile*>(h);
  {
    std::lock_guard<std::mutex> g(f->io_mu);
    if (f->cached_name == name &&
        static_cast<int64_t>(f->cached_payload.size()) <= cap) {
      memcpy(dst, f->cached_payload.data(), f->cached_payload.size());
      f->cached_name.clear();
      std::vector<uint8_t>().swap(f->cached_payload);
      return 1;
    }
  }
  Ticket t;
  if (!fetch(f, name, &t)) return -1;
  if (static_cast<int64_t>(t.payload.size()) > cap) return -2;
  memcpy(dst, t.payload.data(), t.payload.size());
  return static_cast<int>(t.payload.size() > 0);
}

// ---- prefetch pool API ----
void* nlp_create(int n_threads) {
  auto* pool = new Pool();
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i) pool->workers.emplace_back(worker_loop, pool);
  return pool;
}

void nlp_destroy(void* p) {
  auto* pool = static_cast<Pool*>(p);
  {
    std::lock_guard<std::mutex> lk(pool->mu);
    pool->stop = true;
  }
  pool->cv_work.notify_all();
  for (auto& w : pool->workers) w.join();
  delete pool;
}

long nlp_submit(void* p, const char* path, const char* member) {
  auto* pool = static_cast<Pool*>(p);
  std::string spath(path), smember(member);
  std::shared_ptr<NpzFile> file;
  {
    std::lock_guard<std::mutex> lk(pool->files_mu);
    auto it = pool->files.find(spath);
    if (it != pool->files.end()) {
      file = it->second.first;
      pool->lru.erase(it->second.second);
      pool->lru.push_front(spath);
      it->second.second = pool->lru.begin();
    } else {
      file.reset(open_npz(spath.c_str()));
      if (!file) return -1;
      pool->lru.push_front(spath);
      pool->files[spath] = {file, pool->lru.begin()};
      while (pool->files.size() > Pool::kMaxOpenFiles) {
        pool->files.erase(pool->lru.back());
        pool->lru.pop_back();
      }
    }
  }
  long id;
  {
    std::lock_guard<std::mutex> lk(pool->mu);
    id = pool->next_id++;
    pool->tickets[id] = std::make_unique<Ticket>();
    pool->queue.emplace_back(id, [file, smember](Ticket* t) {
      t->ok = fetch(file.get(), smember, t);
    });
  }
  pool->cv_work.notify_one();
  return id;
}


// Blocks until the ticket is decoded; fills metadata.  Second call with a
// buffer copies payload and retires the ticket.
int nlp_wait_info(void* p, long id, char* dtype16, int64_t* shape8, int* ndim,
                  int64_t* nbytes) {
  auto* pool = static_cast<Pool*>(p);
  std::unique_lock<std::mutex> lk(pool->mu);
  auto it = pool->tickets.find(id);
  if (it == pool->tickets.end()) return -1;
  pool->cv_done.wait(lk, [&] { return it->second->done; });
  if (!it->second->ok) {
    pool->tickets.erase(it);
    return -2;
  }
  Ticket* t = it->second.get();
  snprintf(dtype16, 16, "%s", t->dtype.c_str());
  *ndim = static_cast<int>(t->shape.size());
  for (size_t i = 0; i < t->shape.size() && i < 8; ++i) shape8[i] = t->shape[i];
  *nbytes = static_cast<int64_t>(t->payload.size());
  return 0;
}

// Drop a ticket without collecting it (e.g. an interrupted epoch).  A still-
// queued job is removed; an in-flight job's result is dropped by the worker
// when it finds the ticket gone.
int nlp_discard(void* p, long id) {
  auto* pool = static_cast<Pool*>(p);
  std::lock_guard<std::mutex> lk(pool->mu);
  for (auto it = pool->queue.begin(); it != pool->queue.end(); ++it) {
    if (it->first == id) {
      pool->queue.erase(it);
      break;
    }
  }
  return pool->tickets.erase(id) ? 0 : -1;
}

int nlp_collect(void* p, long id, void* dst, int64_t cap) {
  auto* pool = static_cast<Pool*>(p);
  std::unique_lock<std::mutex> lk(pool->mu);
  auto it = pool->tickets.find(id);
  if (it == pool->tickets.end()) return -1;
  pool->cv_done.wait(lk, [&] { return it->second->done; });
  Ticket* t = it->second.get();
  if (!t->ok || static_cast<int64_t>(t->payload.size()) > cap) {
    pool->tickets.erase(it);
    return -2;
  }
  memcpy(dst, t->payload.data(), t->payload.size());
  pool->tickets.erase(it);
  return 0;
}

}  // extern "C"
