"""The repository's measurement scripts, ported to the card.

The counterparts of `scripts/`: `roofline_audit` (the serving pipeline's
stages against the card's peaks), `bench_train_step` (the GATsSPG
training step), `profile_pnp` (RANSAC-PnP's two launches on the card:
time, launches, host syncs), `audit_collectives` (the collective bytes of the
points-sharded matcher and the train step, over ranks),
`bench_pair_batching` (map's batched pair matchers against the serial
loop), `bench_matcher_parts` (GATsSPG with 0, 2 and 4 blocks),
`bench_mixed_attention` (the matcher's mixed-precision attention A/B),
`profile_sp_layers` and `profile_superpoint_parts` (SuperPoint by layer
and by part), `bench_sp_front`, `bench_sp_score` and `bench_sp_variants`
(SuperPoint's front end in its semantics-preserving forms, each held
against its default; `--device cpu` runs them on the host) and
`demo_pipeline` (parse-scan, map and demo in one command); the headline
frames/s is `onepose_tpu_torch.bench`. Each runs on the card and raises
without one:

    python -m onepose_tpu_torch.scripts.roofline_audit [--sweep]
    python -m onepose_tpu_torch.scripts.bench_train_step [batch] [steps] [bf16]
    python -m onepose_tpu_torch.scripts.profile_pnp
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m onepose_tpu_torch.scripts.audit_collectives [n3 ...] [--backend gloo]
    python -m onepose_tpu_torch.scripts.bench_pair_batching [n_kpts] [n_pairs]
    python -m onepose_tpu_torch.scripts.bench_matcher_parts
    python -m onepose_tpu_torch.scripts.bench_mixed_attention
    python -m onepose_tpu_torch.scripts.profile_sp_layers
    python -m onepose_tpu_torch.scripts.profile_superpoint_parts
    python -m onepose_tpu_torch.scripts.bench_sp_front [--device cpu]
    python -m onepose_tpu_torch.scripts.bench_sp_score [--device cpu]
    python -m onepose_tpu_torch.scripts.bench_sp_variants [--device cpu]
    python -m onepose_tpu_torch.scripts.demo_pipeline <obj_dir> [--with-tracking]
"""
