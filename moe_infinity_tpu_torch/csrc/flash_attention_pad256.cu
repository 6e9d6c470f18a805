// The zero-padded instances of K1, K2 and K4 (flash_attention.cuh) of
// width 256: every head dim from 129 to 256, the true head dim a runtime
// argument. A translation unit of their own, so that they build beside
// flash_attention.cu's instances and the other width's, not after
// them.
#include "flash_attention.cuh"

// mit_decode_rows (flash_attention.cu) at this width's head dims.
extern "C" int mit_decode_rows_pad(
    int kind, const void* q, const void* k, const void* v, void* out,
    const void* qpos, const void* lengths, const void* table,
    const void* mask, const void* bias, long long bsb, long long bsh,
    long long bst, void* part_acc, void* part_ml, void* tickets, int B, int Tq,
    int H, int Hkv, int S, int P, int page, int kv_len, int causal,
    int round_p, int kc, int NS, int G, float scale, float softcap,
    int is_bf16, int head_dim, void* stream) {
  return decode_rows_padded<256>(kind, q, k, v, out, qpos, lengths, table, mask,
                                bias, bsb, bsh, bst, part_acc, part_ml, tickets,
                                B, Tq, H, Hkv, S, P, page, kv_len, causal,
                                round_p, kc, NS, G, scale, softcap, is_bf16,
                                head_dim, stream);
}

// mit_flash_attend (flash_attention.cu) at this width's head dims.
extern "C" int mit_flash_attend_pad(const void* q, const void* k, const void* v,
                                    const void* qpos, const void* bias,
                                    long long bsb, long long bsh, long long bst,
                                    const void* mask, void* out, int B, int Tq,
                                    int H, int Hkv, int S, int kv_len,
                                    int causal, float scale, float softcap,
                                    int is_bf16, int head_dim, void* stream) {
  return flash_attend_padded<256>(q, k, v, qpos, bias, bsb, bsh, bst, mask, out,
                                 B, Tq, H, Hkv, S, kv_len, causal, scale,
                                 softcap, is_bf16, head_dim, stream);
}
