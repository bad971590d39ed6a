"""The attention studies of scripts/studies/, ported to the card.

Each module keeps its JAX study's file name and question, and runs the
port's hand-written kernels (ops/study_attention.py, ops/study_int8.py)
at the UNet's 512 px attention shapes, printing one line per (shape,
candidate) with its time, rate and error against the fp32 reference,
ended by the card's name and power limit. Run one on the card with

    python -m storygen_tpu_torch.studies.bench_attn_v2

or on the CPU (plain versions, host-clock times) with `--device cpu`.
The conv studies of scripts/studies/ reach no Pallas kernel and are not
ported.
"""
