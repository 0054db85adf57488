// The row update's launchers with a bf16 state slab (embedding_update.cuh:
// STATEFUL_SR_LAUNCHER).
#include "embedding_update.cuh"

STATEFUL_SR_LAUNCHER(embedding_update_momentum_bf16, Op::kMomentumBf16)
STATEFUL_SR_LAUNCHER(embedding_update_adagrad_bf16, Op::kAdagradBf16)
