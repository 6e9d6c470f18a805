// The entry points of K1, K2 and K4 at head dim 64 or 128
// (flash_attention.cuh) and of K5 at latent width 512 and rope width 64
// (mla.cuh).
#include "flash_attention.cuh"
#include "mla.cuh"

// The decode body for kind 0 (K1: contiguous cache, qpos [B, 1]), 1 (K4:
// pool, table [B, P], lengths [B], S = P * page) and 2 (K2 with
// Tq * rep <= 8 query rows per kv head: bias, qpos [B, Tq], round_p). kc
// (a multiple of 64), NS and G = ceil(Tq * rep / 8) are the wrapper's plan;
// scratch is used when NS > 1: part_acc [B, Hkv, NS, Tq * rep, head_dim]
// and part_ml [.., 2], f32, tickets [B, Hkv, G]. head_dim is 64 or 128
// (the padded instances' mit_decode_rows_pad, flash_attention_pad128.cu and
// flash_attention_pad256.cu, take the others).
extern "C" int mit_decode_rows(
    int kind, const void* q, const void* k, const void* v, void* out,
    const void* qpos, const void* lengths, const void* table,
    const void* mask, const void* bias, long long bsb, long long bsh,
    long long bst, void* part_acc, void* part_ml, void* tickets, int B, int Tq,
    int H, int Hkv, int S, int P, int page, int kv_len, int causal,
    int round_p, int kc, int NS, int G, float scale, float softcap,
    int is_bf16, int head_dim, void* stream) {
  DecArgs a;
  if ((head_dim != 64 && head_dim != 128) ||
      !dec_args(a, kind, q, k, v, out, qpos, lengths, table, mask, bias, bsb,
                bsh, bst, part_acc, part_ml, tickets, B, Tq, H, Hkv, S, P, page,
                kv_len, causal, round_p, kc, NS, G, scale, softcap, head_dim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return head_dim == 64 ? launch_rows<__nv_bfloat16, 64, false>(kind, a, B, st)
                          : launch_rows<__nv_bfloat16, 128, false>(kind, a, B, st);
  return head_dim == 64 ? launch_rows<float, 64, false>(kind, a, B, st)
                        : launch_rows<float, 128, false>(kind, a, B, st);
}

// K2 with more than 8 query rows per kv head at head dim 64 or 128:
// tensor cores for bf16, the CUDA cores for f32.
extern "C" int mit_flash_attend(const void* q, const void* k, const void* v,
                                const void* qpos, const void* bias,
                                long long bsb, long long bsh, long long bst,
                                const void* mask, void* out, int B, int Tq,
                                int H, int Hkv, int S, int kv_len, int causal,
                                float scale, float softcap, int is_bf16,
                                int head_dim, void* stream) {
  if (!attend_shape_ok(B, H, Hkv, head_dim) || (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = head_dim == 64 ? launch_attend<64, false> : launch_attend<128, false>;
  return launch(q, k, v, qpos, bias, bsb, bsh, bst, mask, out, B, Tq, H, Hkv,
                S, kv_len, causal, scale, softcap, is_bf16, head_dim, st);
}

// K5 at R 512 and P 64 (every published DeepSeek MLA geometry); the
// arguments are mla.cuh's mla_flash_decode's.
extern "C" int mit_mla_flash_decode(const void* q_lat, const void* q_pe,
                                    const void* c, const void* kpe,
                                    const void* qpos, const void* mask,
                                    void* part_acc, void* part_ml,
                                    void* tickets, void* out, int B, int H,
                                    int S, int R, int P, int kv_len, int kc,
                                    int NS, int CL, float scale,
                                    int is_bf16, void* stream) {
  return mla_flash_decode<false>(q_lat, q_pe, c, kpe, qpos, mask, part_acc, part_ml,
                                 tickets, out, B, H, S, R, P, kv_len, kc, NS, CL, scale,
                                 is_bf16, stream);
}
