"""Whole runs of ``odom-gicp`` on the CPU at a small size (``small.py``): the
driver matches the plain reference; the control (the reference in bfloat16
in the port's place) does not; and a run whose timed path is broken
underneath comes out not correct, for each fault the cell can have: an
aligner that returns its start unchanged, half of a scan's points left out
of the voxel grid, and a pose altered where it is produced, across the street
or along it. The look for a card is skipped (``run.main(device="cpu")``); the
port runs its plain kernels.

The limits here are those of the small size, where 12,000-point scans leave
the aligner less to hold it than the cell's 130,000: each is about a hundred
times what the port's CPU runs read against the reference (the cell's own
limits, set on the card at full size, are in ``benchmark/cells``)."""

import pytest
import torch

from small import run_small

CELL = "odom-gicp"
LIMITS = {"voxel_count_gap": 0.0, "voxel_gap_m": 1e-4, "pose_gap_xy_m": 1e-4,
          "pose_gap_z_m": 1e-4, "chain_gap_z_m": 1e-4}


def _run(**kw):
    rc, result, err = run_small(CELL, seconds=2.0, limits=LIMITS, **kw)
    assert rc == 0 and result is not None, err[-3000:]
    # every checked pair was registered: a verdict on what the run produced
    assert result["checks"]["pairs_missing"]["value"] == 0, err[-3000:]
    return result, err


def test_the_port_matches_the_reference():
    result, err = _run()
    assert result["correct"], err[-3000:]
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_the_control_is_not_correct():
    result, err = _run(control=True)
    assert not result["correct"], err[-3000:]


def _unchanged(monkeypatch):
    """The aligner returns its start: the state a step leaves unchanged."""
    import pcl_tpu_torch.registration as reg

    real = reg.gicp

    def start(source, target, *a, **kw):
        res = real(source, target, *a, **dict(kw, max_iterations=1))
        eye = torch.eye(4, dtype=torch.float32, device=source.xyz.device)
        return res._replace(transform=eye)

    monkeypatch.setattr(reg, "gicp", start)


def _half_batch(monkeypatch):
    """The voxel grid of half of each scan's points."""
    import pcl_tpu_torch.filters as filters

    real = filters.voxel_downsample

    def half(cloud, leaf, *a, **kw):
        keep = torch.arange(cloud.capacity, device=cloud.mask.device) < cloud.capacity // 2
        return real(cloud.with_mask(cloud.mask & keep), leaf, *a, **kw)

    monkeypatch.setattr(filters, "voxel_downsample", half)


def _moved(axis: int):
    """Each pose moved by 5 cm along ``axis`` of the scan (0 across the
    street, 2 along it) where it is produced."""

    def fault(monkeypatch):
        import pcl_tpu_torch.registration as reg

        real = reg.gicp

        def moved(*a, **kw):
            res = real(*a, **kw)
            T = res.transform.clone()
            T[axis, 3] += 0.05
            return res._replace(transform=T)

        monkeypatch.setattr(reg, "gicp", moved)

    return fault


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _moved(0), _moved(2)],
                         ids=["unchanged", "half_batch", "altered_across", "altered_along"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, err = _run()
    assert not result["correct"], err[-3000:]
