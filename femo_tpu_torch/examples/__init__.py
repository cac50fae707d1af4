"""Run scripts of the port, one per run script of the JAX package
(examples/run_*.py), with the same arguments and defaults:

    python -m femo_tpu_torch.examples.run_poisson_opt --nel 16

They run on the card (`config.device`, "cuda").  To run one on the CPU,
set `femo_tpu_torch.config.device = "cpu"` before calling its `main`:

    import femo_tpu_torch
    from femo_tpu_torch.examples import run_poisson_opt
    femo_tpu_torch.config.device = "cpu"
    result = run_poisson_opt.main(["--nel", "8"])

Each script's `main(argv=None)` parses `argv` (the command line when
None), prints what the JAX script prints and returns those values in a
dict, full precision, for tests and chip_smoke.py.
"""
