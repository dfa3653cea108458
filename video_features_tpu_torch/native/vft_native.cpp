// Native runtime IO for video_features_tpu_torch (a copy of the JAX
// package's native/vft_native.cpp).
//
// The reference's resume contract (reference models/_base/base_extractor.py:
// 95-127) treats an output file that exists but fails to load as absent —
// corruption detection by fully loading every array on every resume scan.
// This library hardens and accelerates that contract:
//
//   vft_write_npy    — writes a NumPy .npy v1/v2 file to <path>.tmp.<pid>,
//                      fsyncs, then atomically rename()s into place, so a
//                      preempted worker can never leave a half-written
//                      feature file behind (POSIX rename atomicity).
//   vft_validate_npy — structural corruption check without reading the
//                      payload: parses the magic/version/header, computes the
//                      expected payload size from descr+shape, and compares
//                      with the on-disk size. O(header bytes) instead of the
//                      reference's O(array bytes) per resume scan.
//
// Built on demand by video_features_tpu_torch/native/__init__.py with g++; all
// entry points return 0 on success / negative error codes, never throw.
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr unsigned char kMagic[] = {0x93, 'N', 'U', 'M', 'P', 'Y'};

// "{'descr': '<f4', 'fortran_order': False, 'shape': (3, 4), }" + padding
std::string build_header(const char* descr, const int64_t* shape, int ndim) {
  std::string dict = "{'descr': '";
  dict += descr;
  dict += "', 'fortran_order': False, 'shape': (";
  for (int i = 0; i < ndim; ++i) {
    dict += std::to_string(shape[i]);
    if (ndim == 1 || i + 1 < ndim) dict += ",";
    if (i + 1 < ndim) dict += " ";
  }
  dict += "), }";
  return dict;
}

}  // namespace

extern "C" {

// Error codes (negative): -errno for OS errors, -1000.. for format errors.
enum {
  VFT_EFORMAT = -1000,   // not a .npy file / bad header
  VFT_ETRUNCATED = -1001,  // payload size mismatch (partial write)
  VFT_EHEADER = -1002,   // header unparseable
};

int vft_write_npy(const char* path, const char* descr, const int64_t* shape,
                  int ndim, const void* data, int64_t nbytes) {
  std::string dict = build_header(descr, shape, ndim);
  // v1 header: 10-byte preamble + dict padded with spaces to a multiple of
  // 64, '\n'-terminated; v2 (4-byte length) when the dict exceeds 65535
  bool v2 = false;
  size_t preamble = 10;
  size_t unpadded = preamble + dict.size() + 1;
  size_t total = (unpadded + 63) / 64 * 64;
  if (total - preamble > 65535) {
    v2 = true;
    preamble = 12;
    unpadded = preamble + dict.size() + 1;
    total = (unpadded + 63) / 64 * 64;
  }
  std::string header;
  header.reserve(total);
  header.append(reinterpret_cast<const char*>(kMagic), 6);
  header.push_back(v2 ? 2 : 1);
  header.push_back(0);
  size_t hlen = total - preamble;
  if (v2) {
    uint32_t n = static_cast<uint32_t>(hlen);
    header.append(reinterpret_cast<const char*>(&n), 4);
  } else {
    uint16_t n = static_cast<uint16_t>(hlen);
    header.append(reinterpret_cast<const char*>(&n), 2);
  }
  header += dict;
  header.append(total - unpadded, ' ');
  header.push_back('\n');

  std::string tmp = std::string(path) + ".tmp." + std::to_string(getpid());
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  auto write_all = [&](const char* p, int64_t n) -> int {
    while (n > 0) {
      ssize_t w = write(fd, p, static_cast<size_t>(n));
      if (w < 0) {
        if (errno == EINTR) continue;
        return -errno;
      }
      p += w;
      n -= w;
    }
    return 0;
  };
  int rc = write_all(header.data(), static_cast<int64_t>(header.size()));
  if (rc == 0) rc = write_all(static_cast<const char*>(data), nbytes);
  if (rc == 0 && fsync(fd) != 0) rc = -errno;
  if (close(fd) != 0 && rc == 0) rc = -errno;
  if (rc != 0) {
    unlink(tmp.c_str());
    return rc;
  }
  if (rename(tmp.c_str(), path) != 0) {
    rc = -errno;
    unlink(tmp.c_str());
    return rc;
  }
  return 0;
}

// Parses the header and verifies file size == header + itemsize*prod(shape).
// Returns 0 if structurally valid.
int vft_validate_npy(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  unsigned char pre[12];
  ssize_t got = read(fd, pre, 12);
  if (got < 10 || memcmp(pre, kMagic, 6) != 0) {
    close(fd);
    return VFT_EFORMAT;
  }
  int major = pre[6];
  size_t hlen, preamble;
  if (major == 1) {
    hlen = static_cast<size_t>(pre[8]) | (static_cast<size_t>(pre[9]) << 8);
    preamble = 10;
  } else if (major == 2 || major == 3) {
    if (got < 12) {
      close(fd);
      return VFT_EFORMAT;
    }
    hlen = static_cast<size_t>(pre[8]) | (static_cast<size_t>(pre[9]) << 8) |
           (static_cast<size_t>(pre[10]) << 16) |
           (static_cast<size_t>(pre[11]) << 24);
    preamble = 12;
  } else {
    close(fd);
    return VFT_EFORMAT;
  }
  if (hlen > (1u << 20)) {  // pathological header
    close(fd);
    return VFT_EHEADER;
  }
  std::string dict(hlen, '\0');
  if (lseek(fd, static_cast<off_t>(preamble), SEEK_SET) < 0 ||
      read(fd, dict.data(), hlen) != static_cast<ssize_t>(hlen)) {
    close(fd);
    return VFT_EFORMAT;
  }
  struct stat st;
  if (fstat(fd, &st) != 0) {
    int rc = -errno;
    close(fd);
    return rc;
  }
  close(fd);

  // descr: '<f4' style simple strings only; compound dtypes (rare, not
  // produced by this framework) report VFT_EHEADER and the caller falls
  // back to a full np.load
  size_t dpos = dict.find("'descr'");
  if (dpos == std::string::npos) return VFT_EHEADER;
  size_t q1 = dict.find('\'', dpos + 7);
  if (q1 == std::string::npos) return VFT_EHEADER;
  size_t q2 = dict.find('\'', q1 + 1);
  if (q2 == std::string::npos) return VFT_EHEADER;
  std::string descr = dict.substr(q1 + 1, q2 - q1 - 1);
  if (descr.size() < 2) return VFT_EHEADER;
  size_t digits = descr.find_first_of("0123456789");
  if (digits == std::string::npos) return VFT_EHEADER;
  long itemsize = strtol(descr.c_str() + digits, nullptr, 10);
  if (itemsize <= 0) return VFT_EHEADER;
  if (descr.find('U') != std::string::npos) itemsize *= 4;  // unicode chars

  size_t spos = dict.find("'shape'");
  if (spos == std::string::npos) return VFT_EHEADER;
  size_t p1 = dict.find('(', spos);
  size_t p2 = dict.find(')', spos);
  if (p1 == std::string::npos || p2 == std::string::npos || p2 < p1)
    return VFT_EHEADER;
  int64_t count = 1;
  std::string nums = dict.substr(p1 + 1, p2 - p1 - 1);
  const char* p = nums.c_str();
  while (*p) {
    while (*p == ' ' || *p == ',') ++p;
    if (!*p) break;
    char* end;
    long long dim = strtoll(p, &end, 10);
    if (end == p) return VFT_EHEADER;
    if (dim < 0) return VFT_EHEADER;
    count *= dim;
    p = end;
  }
  int64_t expected =
      static_cast<int64_t>(preamble + hlen) + count * itemsize;
  if (st.st_size != expected) return VFT_ETRUNCATED;
  return 0;
}

}  // extern "C"
