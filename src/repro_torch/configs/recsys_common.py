"""The recsys archetypes' shapes (copy of ``RECSYS_SHAPES`` from
``repro/configs/recsys_common.py``).  The reference's ``recsys_archdef`` /
``ArchDef`` registry serves its dry run, which the port has not yet
(ROADMAP queue 1 item 10, with ``launch/dryrun.py``)."""

RECSYS_SHAPES = {
    "train_batch":    dict(kind="train", batch=65536),
    "serve_p99":      dict(kind="score", batch=512),
    "serve_bulk":     dict(kind="score", batch=262144),
    # 2^20 candidates: divisible by the 512-device mesh (the brief's 1e6
    # padded up)
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1 << 20),
}
