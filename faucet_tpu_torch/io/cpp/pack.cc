// Copied verbatim from faucet_tpu/io/cpp/pack.cc: the port imports nothing
// of faucet_tpu. faucet_tpu_torch/io/native.py builds it into
// faucet_tpu_torch/_build/.
// Native FASTA/FASTQ reader + 2-bit packer.
//
// Reference analogue: the getline reader loop of the reference driver
// (SURVEY.md §2.1 "Read I/O" [C:med]) — but fused with base encoding so
// the host-side hot loop (parse + pack, SURVEY.md §7.1.5) runs in C++
// at memory speed and hands the device fixed-shape uint8 batches
// directly. Supports plain files, gzip (zlib), and FIFOs/stdin
// (streaming mode). Exposed with a plain C ABI for ctypes (no pybind11
// in this image).
//
// Batch format matches faucet_tpu.core.kmer.pack_reads: codes A=0 C=1
// G=2 T=3, anything else 4; reads truncated at max_len; lens int32.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <zlib.h>

namespace {

struct Reader {
  gzFile gz = nullptr;      // zlib handles plain files transparently
  bool fastq = false;
  bool eof = false;
  // buffered line reader
  char *buf = nullptr;
  size_t cap = 0;
  size_t len = 0;           // valid bytes in buf
  size_t pos = 0;           // cursor
  char *line = nullptr;     // assembled line storage
  size_t line_cap = 0;
  // FASTA state: sequences may span multiple lines
  char *pend = nullptr;     // pending sequence carry (FASTA)
  size_t pend_cap = 0;
  size_t pend_len = 0;
  bool pend_valid = false;
};

uint8_t g_code[256];

struct CodeInit {
  CodeInit() {
    memset(g_code, 4, sizeof(g_code));
    g_code[(unsigned)'A'] = g_code[(unsigned)'a'] = 0;
    g_code[(unsigned)'C'] = g_code[(unsigned)'c'] = 1;
    g_code[(unsigned)'G'] = g_code[(unsigned)'g'] = 2;
    g_code[(unsigned)'T'] = g_code[(unsigned)'t'] = 3;
  }
} g_code_init;

// Read one line (without newline) into r->line; returns length or -1 at EOF.
long next_line(Reader *r) {
  size_t out = 0;
  for (;;) {
    if (r->pos >= r->len) {
      if (r->eof) break;
      if (r->cap == 0) {
        r->cap = 1 << 20;
        r->buf = (char *)malloc(r->cap);
      }
      int n = gzread(r->gz, r->buf, (unsigned)r->cap);
      if (n <= 0) {
        r->eof = true;
        break;
      }
      r->len = (size_t)n;
      r->pos = 0;
    }
    char *nl = (char *)memchr(r->buf + r->pos, '\n', r->len - r->pos);
    size_t take = (nl ? (size_t)(nl - (r->buf + r->pos)) : r->len - r->pos);
    if (out + take + 1 > r->line_cap) {
      r->line_cap = (out + take + 1) * 2 + 64;
      r->line = (char *)realloc(r->line, r->line_cap);
    }
    memcpy(r->line + out, r->buf + r->pos, take);
    out += take;
    r->pos += take + (nl ? 1 : 0);
    if (nl) {
      r->line[out] = 0;
      // strip \r
      if (out && r->line[out - 1] == '\r') r->line[--out] = 0;
      return (long)out;
    }
  }
  if (out) {
    r->line[out] = 0;
    return (long)out;
  }
  return -1;
}

void encode_into(const char *s, long n, uint8_t *dst, int32_t *len_out,
                 int max_len) {
  int m = (int)(n < max_len ? n : max_len);
  for (int i = 0; i < m; i++) dst[i] = g_code[(unsigned char)s[i]];
  for (int i = m; i < max_len; i++) dst[i] = 4;
  *len_out = m;
}

// Returns 1 if a read was produced, 0 at EOF.
int next_read(Reader *r, uint8_t *dst, int32_t *len_out, int max_len) {
  if (r->fastq) {
    for (;;) {
      long n = next_line(r);
      if (n < 0) return 0;
      if (n == 0) continue;
      if (r->line[0] != '@') continue;  // resync
      long sn = next_line(r);
      if (sn < 0) return 0;
      encode_into(r->line, sn, dst, len_out, max_len);
      next_line(r);  // '+'
      next_line(r);  // quals
      return 1;
    }
  }
  // FASTA: accumulate until next '>' or EOF
  for (;;) {
    long n = next_line(r);
    if (n < 0) {
      if (r->pend_valid && r->pend_len) {
        encode_into(r->pend, (long)r->pend_len, dst, len_out, max_len);
        r->pend_len = 0;
        r->pend_valid = false;
        return 1;
      }
      return 0;
    }
    if (n == 0) continue;
    if (r->line[0] == '>') {
      if (r->pend_valid && r->pend_len) {
        encode_into(r->pend, (long)r->pend_len, dst, len_out, max_len);
        r->pend_len = 0;
        return 1;  // pend_valid stays: next record already started
      }
      r->pend_valid = true;
      r->pend_len = 0;
      continue;
    }
    if (!r->pend_valid) continue;  // sequence before any header: skip
    if (r->pend_len + (size_t)n + 1 > r->pend_cap) {
      r->pend_cap = (r->pend_len + n + 1) * 2 + 64;
      r->pend = (char *)realloc(r->pend, r->pend_cap);
    }
    memcpy(r->pend + r->pend_len, r->line, (size_t)n);
    r->pend_len += (size_t)n;
  }
}

}  // namespace

extern "C" {

void *ft_open(const char *path, int fastq) {
  gzFile gz;
  if (strcmp(path, "-") == 0) {
    gz = gzdopen(0, "rb");
  } else {
    gz = gzopen(path, "rb");
  }
  if (!gz) return nullptr;
  Reader *r = new Reader();
  r->gz = gz;
  r->fastq = fastq != 0;
  return r;
}

// Fill up to `batch` reads; rows beyond the returned count are zero-length
// padding (bases already 4-filled). Returns number of reads produced.
int ft_next_batch(void *h, uint8_t *bases, int32_t *lens, int batch,
                  int max_len) {
  Reader *r = (Reader *)h;
  int got = 0;
  while (got < batch) {
    if (!next_read(r, bases + (size_t)got * max_len, lens + got, max_len))
      break;
    got++;
  }
  for (int i = got; i < batch; i++) {
    memset(bases + (size_t)i * max_len, 4, (size_t)max_len);
    lens[i] = 0;
  }
  return got;
}

void ft_close(void *h) {
  Reader *r = (Reader *)h;
  if (r->gz) gzclose(r->gz);
  free(r->buf);
  free(r->line);
  free(r->pend);
  delete r;
}

}  // extern "C"
