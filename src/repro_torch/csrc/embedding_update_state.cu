// The row update's momentum and Adagrad launchers (embedding_update.cuh:
// STATEFUL_LAUNCHER).
#include "embedding_update.cuh"

STATEFUL_LAUNCHER(embedding_update_momentum, Op::kMomentum)
STATEFUL_LAUNCHER(embedding_update_adagrad, Op::kAdagrad)
