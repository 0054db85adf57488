// The row update's launchers of the split pair and the fp32 table, and the
// long schedule's sizes; the kernels are in embedding_update.cuh.
#include "embedding_update.cuh"

// The long schedule's threshold: runs of this many positions or more
extern "C" int embedding_update_long_run() { return kLongRun; }

// The int64 words of the long runs' list that a launch on a stream of L
// positions needs
extern "C" int64_t embedding_update_list_words(int64_t L) { return list_words(L); }

// Sorted stream rows/bags/msk [L] int32, wgt [L] fp32; dY [bags, E] bf16, or
// fp32 when dy_f32; hi/lo [M, E] 16-bit (split) or W [M, E] fp32, updated in
// place; runs int64 [embedding_update_list_words(L)] scratch, runs[0] left
// holding the number of runs of embedding_update_long_run() positions or
// more.  Any E: an odd one, or a slab off its pairs' alignment, takes the
// narrow path.  Returns the CUDA error of the launch (0 = none).
extern "C" int embedding_update_split(const void* rows, const void* bags, const void* msk,
                                      const void* wgt, const void* dY, int dy_f32, void* hi,
                                      void* lo, void* runs, int64_t L, int E, float lr,
                                      void* stream) {
  return launch<Op::kSplit>(rows, bags, msk, wgt, dY, dy_f32, Store{hi, lo, lr, 0.f, nullptr},
                            runs, L, E, stream);
}

extern "C" int embedding_update_fp32(const void* rows, const void* bags, const void* msk,
                                     const void* wgt, const void* dY, int dy_f32, void* W,
                                     void* runs, int64_t L, int E, float lr, void* stream) {
  return launch<Op::kFp32>(rows, bags, msk, wgt, dY, dy_f32, Store{W, nullptr, lr, 0.f, nullptr},
                           runs, L, E, stream);
}
