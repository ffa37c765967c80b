"""avenir-tpu's PyTorch/CUDA port, for one NVIDIA H100.

The JAX package ``avenir_tpu`` is the reference; this package computes the
same job outputs with PyTorch and hand-written CUDA kernels, and imports
nothing of JAX or of ``avenir_tpu``.  Its layout follows the reference's,
so a module's counterpart has the same path:

- ``core``     -- schema, properties config, CSV I/O, counters, the
                  column encoder, the ingest cache and the chunked
                  host-to-device fold;
- ``ops``      -- the counting and distance engines, the kernel wrappers
                  (histogram, fused distance + top-k) and XLA's float math;
- ``csrc``     -- the CUDA sources, built with ``nvcc`` at first use;
- ``models``   -- the ported jobs (Naive Bayes train and batch score; the
                  kNN distance job, joiner and voting; greedy clustering);
- ``device``   -- the one device a job runs on (the mesh's counterpart);
- ``convert``  -- moves the reference's numpy state onto port tensors;
- ``datagen``  -- the seeded telecom-churn and blobs generators;
- ``cli``      -- ``python -m avenir_tpu_torch <Job> -Dconf.path=... in out``.

Entry points run on ``cuda:0`` unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``), and raise when there is no card.
"""

__version__ = "0.1.0"
