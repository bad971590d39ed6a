"""Command-line entry points of the port, each run as
`python -m storygen_tpu_torch.scripts.<name>`: inference,
precompute_latents, train, inference_coco_val, serve and build_dataset,
and the timers bench (the JAX package's bench.py), bench_story and
bench_train. Each takes the flags of the JAX package's script of the
same name, with
`--device` (default cuda; cpu only when asked) in place of `--platform`,
and has a `main(argv)` that tests and other programs call in process."""
