"""Velodyne HDL/VLP grabber — pcap packet decoding to clouds.

Counterpart of ``pcl_tpu/io/velodyne.py``: packet decoding, packet encoding
and the pcap reader and writer are a copy of its numpy code (the float32
trigonometry included), so that decoded points and written files are the JAX
package's bit for bit. Each sweep is moved to ``device`` (default CUDA) once
it is whole.

Capability match for pcl::HDLGrabber / pcl::VLPGrabber (reference:
io/include/pcl/io/hdl_grabber.h, vlp_grabber.h + io/src/hdl_grabber.cpp
packet layout). Decodes the standard 1206-byte Velodyne data packet:
12 firing blocks x (2-byte 0xEEFF flag, 2-byte azimuth in 0.01 deg,
32 x (2-byte distance in 2 mm units, 1-byte intensity)), 4-byte timestamp
+ 2-byte factory field. Supported sensors: VLP-16 (two 16-laser firings
per block) and HDL-32E (32 lasers per block), using the fixed vertical
angle tables the reference hardcodes (hdl_grabber.cpp lines ~100).

Packet decode is fully vectorized numpy (all blocks/lasers at once);
``PcapVelodyneGrabber`` walks a classic pcap file (struct-parsed, no
libpcap) and emits one cloud per revolution, like the reference's
sweep-complete signal (sweep_xyzi callbacks).
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from pcl_tpu_torch.core.cloud import Cloud, make_cloud
from pcl_tpu_torch.io.grabber import Grabber

VLP16_VERT_ANGLES = np.array(
    [-15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15],
    np.float32,
)
HDL32_VERT_ANGLES = np.array(
    [
        -30.67, -9.33, -29.33, -8.0, -28.0, -6.67, -26.67, -5.33,
        -25.33, -4.0, -24.0, -2.67, -22.67, -1.33, -21.33, 0.0,
        -20.0, 1.33, -18.67, 2.67, -17.33, 4.0, -16.0, 5.33,
        -14.67, 6.67, -13.33, 8.0, -12.0, 9.33, -10.67, 10.67,
    ],
    np.float32,
)

PACKET_SIZE = 1206
_BLOCKS = 12
_LASERS_PER_BLOCK = 32
_FLAG = 0xEEFF


def decode_packet(
    data: bytes, model: str = "VLP16"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One 1206-byte packet -> (xyz [N,3] f32, intensity [N] f32,
    azimuth_deg [N] f32); zero-distance returns dropped."""
    if len(data) != PACKET_SIZE:
        raise ValueError(f"bad packet size {len(data)}")
    raw = np.frombuffer(data[: _BLOCKS * 100], np.uint8).reshape(_BLOCKS, 100)
    flags = raw[:, 0].astype(np.uint16) | (raw[:, 1].astype(np.uint16) << 8)
    az = (raw[:, 2].astype(np.float32) + raw[:, 3].astype(np.float32) * 256.0) / 100.0
    body = raw[:, 4:].reshape(_BLOCKS, _LASERS_PER_BLOCK, 3)
    dist = (
        body[..., 0].astype(np.float32) + body[..., 1].astype(np.float32) * 256.0
    ) * 0.002  # 2 mm units -> meters
    inten = body[..., 2].astype(np.float32)

    ok_block = flags == _FLAG
    if model.upper() in ("VLP16", "VLP-16"):
        vert = np.tile(VLP16_VERT_ANGLES, 2)  # two firing sequences per block
    elif model.upper() in ("HDL32", "HDL-32", "HDL32E", "HDL-32E"):
        vert = HDL32_VERT_ANGLES
    else:
        raise ValueError(f"unknown model {model}")
    vrad = np.deg2rad(vert)[None, :]
    arad = np.deg2rad(az)[:, None]

    cosv = np.cos(vrad)
    x = dist * cosv * np.sin(arad)
    y = dist * cosv * np.cos(arad)
    z = dist * np.sin(vrad)
    xyz = np.stack([x, y, z], -1)

    valid = (dist > 0.0) & ok_block[:, None]
    az_full = np.broadcast_to(az[:, None], dist.shape)
    return (
        xyz[valid].astype(np.float32),
        inten[valid].astype(np.float32),
        az_full[valid].astype(np.float32),
    )


def encode_packet(
    azimuths: np.ndarray, distances: np.ndarray, intensities: np.ndarray
) -> bytes:
    """Inverse of decode_packet for testing/simulation: [12] block azimuths
    (deg), [12,32] distances (m), [12,32] intensity."""
    out = bytearray()
    for b in range(_BLOCKS):
        out += struct.pack("<H", _FLAG)
        out += struct.pack("<H", int(round(azimuths[b] * 100.0)) % 36000)
        for l in range(_LASERS_PER_BLOCK):
            d = int(round(distances[b, l] / 0.002))
            out += struct.pack("<HB", min(d, 65535), int(intensities[b, l]) & 0xFF)
    out += struct.pack("<IH", 0, 0x2237)  # timestamp + factory (VLP-16 dual)
    assert len(out) == PACKET_SIZE
    return bytes(out)


# ------------------------------------------------------------------ pcap

_PCAP_MAGIC = (0xA1B2C3D4, 0xD4C3B2A1)


def write_pcap(path: str, packets: List[bytes]) -> None:
    """Minimal pcap writer (UDP payloads wrapped in fake eth/ip/udp headers
    of 42 bytes, as Velodyne capture files contain)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1))
        for p in packets:
            frame = b"\x00" * 42 + p
            f.write(struct.pack("<IIII", 0, 0, len(frame), len(frame)))
            f.write(frame)


def read_pcap_packets(path: str) -> Iterator[bytes]:
    """Yield Velodyne-sized UDP payloads from a pcap file."""
    with open(path, "rb") as f:
        head = f.read(24)
        (magic,) = struct.unpack("<I", head[:4])
        if magic not in _PCAP_MAGIC:
            raise ValueError("not a pcap file")
        swap = magic == 0xD4C3B2A1
        fmt = ">IIII" if swap else "<IIII"
        while True:
            rec = f.read(16)
            if len(rec) < 16:
                break
            _, _, incl, _ = struct.unpack(fmt, rec)
            frame = f.read(incl)
            if len(frame) >= 42 + PACKET_SIZE:
                payload = frame[-PACKET_SIZE:]
                yield payload


class PcapVelodyneGrabber(Grabber):
    """Replay a Velodyne pcap; emits one Cloud (with ``intensity`` attr)
    per full revolution — azimuth wrap detection, like the reference's
    toggleSweep (hdl_grabber.cpp)."""

    def __init__(self, path: str, model: str = "VLP16", device=None):
        super().__init__()
        self.path = path
        self.model = model
        self.device = device

    def _cloud(self, buf_xyz, buf_i) -> Cloud:
        import torch

        from pcl_tpu_torch.core.cloud import _device
        dev = _device(self.device)
        c = make_cloud(np.concatenate(buf_xyz), device=dev)
        return c.with_attrs(intensity=torch.as_tensor(np.concatenate(buf_i), device=dev))

    def _sweeps(self):
        buf_xyz: List[np.ndarray] = []
        buf_i: List[np.ndarray] = []
        last_az = None
        for pkt in read_pcap_packets(self.path):
            xyz, inten, az = decode_packet(pkt, self.model)
            if len(az) == 0:
                continue
            if last_az is not None and az[0] < last_az - 180.0 and buf_xyz:
                yield self._cloud(buf_xyz, buf_i)
                buf_xyz, buf_i = [], []
            buf_xyz.append(xyz)
            buf_i.append(inten)
            last_az = az[-1]
        if buf_xyz:
            yield self._cloud(buf_xyz, buf_i)

    def _produce(self):
        yield from self._sweeps()
