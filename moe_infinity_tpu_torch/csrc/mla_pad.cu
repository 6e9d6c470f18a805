// The zero-padded instance of K5 (mla.cuh): every latent width R that is a
// multiple of 128 up to 512 and every rope width P from 1 to 64, the true
// widths runtime arguments. A translation unit of its own, so that it
// builds beside flash_attention.cu's 512/64 instance, not after it.
#include "mla.cuh"

// mit_mla_flash_decode (flash_attention.cu) at the other widths.
extern "C" int mit_mla_flash_decode_pad(const void* q_lat, const void* q_pe,
                                        const void* c, const void* kpe,
                                        const void* qpos, const void* mask,
                                        void* part_acc, void* part_ml,
                                        void* tickets, void* out, int B, int H,
                                        int S, int R, int P, int kv_len, int kc,
                                        int NS, int CL, float scale,
                                        int is_bf16, void* stream) {
  return mla_flash_decode<true>(q_lat, q_pe, c, kpe, qpos, mask, part_acc, part_ml,
                                tickets, out, B, H, S, R, P, kv_len, kc, NS, CL, scale,
                                is_bf16, stream);
}
