"""The repository's measurement scripts, ported to the card.

`roofline_audit` (the serving pipeline's stages against the card's
peaks) and `bench_train_step` (the GATsSPG training step), the
counterparts of `scripts/roofline_audit.py` and
`scripts/bench_train_step.py`; the headline frames/s is
`onepose_tpu_torch.bench`. Each runs on the card and raises without one:

    python -m onepose_tpu_torch.scripts.roofline_audit [--sweep]
    python -m onepose_tpu_torch.scripts.bench_train_step [batch] [steps] [bf16]
"""
