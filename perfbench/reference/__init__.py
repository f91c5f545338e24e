"""The plain reference that decides ``correct``.

``port/`` is a frozen copy of the PyTorch port's plain arithmetic, taken at
the commit that added the benchmark, cut down to what the cells' checks
run: ``config``, ``device``, ``sim`` (observe, the planner on the
diffusion head, the env step, the closed-loop step), ``diffusion`` (the
candidate-minor DDPM sampler, the multi-candidate selection), ``specs``
(``TiledScorer``), ``models/{net,convert}``, ``ops/{dynamics,geometry,
guidance_loss,guidance_kernel,stl}``, ``parallel/mesh`` (one rank) and
``data/synthetic``.  The package name is rewritten, and besides the cuts
these changes only: kernel 1 (``guidance_kernel.guidance_fused``) runs its
plain PyTorch version on any device; ``models/net.py`` casts through
``cast``, which adds the control's precision (``FP8``: matmul operands
rounded to float8 e4m3 with a scale a tensor); ``models/convert.py`` reads
the committed weight files under ``pstl_tpu_torch/weights``.  A path that
no cell runs (another sampler, the superstep, the refinement or backup
solve, the VAE / BC heads, training, the clearance kernels, sharding)
raises ``NotImplementedError(config.HELD)``.

It is not independent of the port: a fault that the port's plain
arithmetic had at that commit is in both sides.  It checks the kernels
against their plain versions, and later changes of the program against
this snapshot.  It imports nothing of the program, ``jax`` or the JAX
package.
"""
