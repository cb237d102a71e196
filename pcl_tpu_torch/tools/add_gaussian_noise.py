"""CLI: add Gaussian noise to a cloud (counterpart of
``pcl_tpu/tools/add_gaussian_noise.py``; reference:
tools/add_gaussian_noise.cpp).

    python -m pcl_tpu_torch.tools.add_gaussian_noise in.pcd out.pcd [-sd 0.01] [-seed 0] [--device cpu]

The JAX tool draws ``jax.random.normal(PRNGKey(seed))``, a stream torch
cannot draw (ROADMAP C17). So the tool is a sampler, ``draw_noise`` (a
``torch.Generator`` seeded with ``-seed`` on the cloud's device), and a core,
``add_noise``, that adds given noise; ``main(noise=...)`` takes the noise
from the caller instead of the sampler.
"""
import argparse
import sys


def draw_noise(cloud, sd: float, seed: int):
    """``[capacity, 3]`` float32 normal draws times ``sd``, from a generator
    seeded ``seed`` on the cloud's device."""
    import torch
    gen = torch.Generator(device=cloud.xyz.device).manual_seed(seed)
    return torch.randn(cloud.xyz.shape, generator=gen, device=cloud.xyz.device,
                       dtype=torch.float32) * sd


def add_noise(cloud, noise):
    """The cloud with ``noise`` added to its valid points; invalid rows zero."""
    import torch
    noise = torch.as_tensor(noise, dtype=torch.float32, device=cloud.xyz.device)
    return cloud.with_xyz(torch.where(cloud.mask[:, None], cloud.xyz + noise, 0.0))


def main(argv=None, noise=None):
    ap = argparse.ArgumentParser(description="Add Gaussian noise to a cloud")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-sd", type=float, default=0.01)
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pcl_tpu_torch import io
    c = io.load(args.input, device=args.device)
    if noise is None:
        noise = draw_noise(c, args.sd, args.seed)
    out = add_noise(c, noise)
    print(f"[add_gaussian_noise] sd={args.sd} on {int(c.count)} points")
    io.save(args.output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
