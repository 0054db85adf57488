// The row update's row-wise Adagrad and frequency-adaptive launchers
// (embedding_update.cuh: STATEFUL_LAUNCHER).
#include "embedding_update.cuh"

STATEFUL_LAUNCHER(embedding_update_adagrad_rowwise, Op::kRowwise)
STATEFUL_LAUNCHER(embedding_update_freq, Op::kFreq)
