"""The port's two user-facing examples, each a `main(argv=None)` that
returns what it checked:

    python3 -m sppark_tpu_torch.examples.ntt_example [field] [lg] [--cpu]
    python3 -m sppark_tpu_torch.examples.msm_example [curve] [lg] [--cpu]

They run on the CUDA card unless --cpu is given; without a card and
without --cpu they raise SpparkError (runtime.resolve).
"""

__all__ = ["ntt_example", "msm_example"]
