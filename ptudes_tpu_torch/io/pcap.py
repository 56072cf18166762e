"""Minimal pcap reader for Ouster captures.

A copy of ``ptudes_tpu.io.pcap`` for the PyTorch port, which imports
nothing of the JAX package; the names and behaviour are the same.

Replaces ouster-sdk's ``pcap.Pcap`` packet source (reference
``src/ptudes/utils.py:171-187``): reads classic pcap (and the common
nanosecond-resolution magic), walks Ethernet/IPv4/UDP encapsulation and
splits payloads into lidar/IMU streams by size. Vectorized batch reading:
the whole file is memory-mapped and record offsets computed in one pass,
so a multi-GB capture splits in ~memory bandwidth time; a C++ fast path
(``native``) does the same splitting off-thread when built.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

MAGIC_US = 0xA1B2C3D4
MAGIC_NS = 0xA1B23C4D

ETH_HDR = 14
ETH_IPV4 = 0x0800
ETH_VLAN = 0x8100
PROTO_UDP = 17


@dataclass
class PacketStream:
    """Payloads of one UDP size-class, with capture timestamps."""
    payloads: np.ndarray  # [N, size] uint8
    ts: np.ndarray        # [N] f64 seconds (capture time)


def _parse_records(buf: memoryview) -> tuple[np.ndarray, np.ndarray, float]:
    """Return (offsets, lengths, ts_scale) of pcap record payloads."""
    if len(buf) < 24:
        raise ValueError("not a pcap file (too short)")
    magic = struct.unpack_from("<I", buf, 0)[0]
    if magic == MAGIC_US:
        ts_scale = 1e-6
        endian = "<"
    elif magic == MAGIC_NS:
        ts_scale = 1e-9
        endian = "<"
    elif magic in (0xD4C3B2A1, 0x4D3CB2A1):
        ts_scale = 1e-6 if magic == 0xD4C3B2A1 else 1e-9
        endian = ">"
    else:
        raise ValueError(f"unknown pcap magic {magic:#x}")

    offsets, lengths, tss = [], [], []
    pos = 24
    n = len(buf)
    u = struct.Struct(endian + "IIII")
    while pos + 16 <= n:
        sec, frac, incl, _orig = u.unpack_from(buf, pos)
        pos += 16
        if pos + incl > n:
            break
        offsets.append(pos)
        lengths.append(incl)
        tss.append(sec + frac * ts_scale)
        pos += incl
    return (np.asarray(offsets, np.int64), np.asarray(lengths, np.int64),
            np.asarray(tss, np.float64))


def _group_by_size(arena: np.ndarray, offs: np.ndarray, lens: np.ndarray,
                   tss: np.ndarray) -> list[tuple[int, PacketStream]]:
    out = []
    for size in np.unique(lens):
        size = int(size)
        if size <= 0:
            continue
        sel = lens == size
        o = offs[sel]
        payloads = arena[o[:, None] + np.arange(size)[None, :]]
        out.append((size, PacketStream(payloads=payloads, ts=tss[sel])))
    out.sort(key=lambda kv: -kv[1].payloads.shape[0])
    return out


def read_pcap_udp(
    path: str,
) -> list[tuple[int, PacketStream]]:
    """Read all UDP datagrams grouped by payload size.

    Returns list of (payload_size, PacketStream) sorted by descending
    count. IPv4 fragments are reassembled — real Ouster lidar packets
    (12-25 KB) always exceed Ethernet MTU, so raw captures carry them
    fragmented (the reference relies on ouster-sdk's pcap layer for this).

    The C++ runtime (``native``) does the split+reassembly in one
    pass when available; the numpy fallback parses all headers vectorized
    and only loops over fragmented datagrams.
    """
    data = np.fromfile(path, np.uint8)

    from .. import native
    res = native.pcap_split_udp(data)
    if res is not None:
        arena, offs, lens, ts_ns = res
        return _group_by_size(arena, offs, lens,
                              ts_ns.astype(np.float64) * 1e-9)

    offsets, lengths, tss = _parse_records(memoryview(data.data))
    if len(offsets) == 0:
        return []

    # --- vectorized Ethernet/IPv4/UDP header parse over all records
    big = lambda a, b: (a.astype(np.int64) << 8) | b  # noqa: E731
    ok = lengths >= ETH_HDR + 20 + 8
    ethertype = big(data[offsets + 12], data[offsets + 13])
    is_vlan = ethertype == ETH_VLAN
    ip_off = offsets + ETH_HDR + np.where(is_vlan, 4, 0)
    ethertype = np.where(
        is_vlan, big(data[offsets + 16], data[offsets + 17]), ethertype)
    ok &= ethertype == ETH_IPV4
    ihl = (data[ip_off].astype(np.int64) & 0x0F) * 4
    ok &= data[ip_off + 9] == PROTO_UDP
    ip_total = big(data[ip_off + 2], data[ip_off + 3])
    ip_total = np.minimum(ip_total, offsets + lengths - ip_off)
    fragfield = big(data[ip_off + 6], data[ip_off + 7])
    mf = (fragfield & 0x2000) != 0
    frag_off = (fragfield & 0x1FFF) * 8
    ippay_off = ip_off + ihl
    ippay_len = np.minimum(ip_total - ihl, offsets + lengths - ippay_off)
    ok &= ippay_len > 0

    # unfragmented datagrams: vectorized group-by-size on the raw buffer
    plain = ok & ~mf & (frag_off == 0)
    udp_len = big(data[ippay_off + 4], data[ippay_off + 5])
    pay_off = ippay_off + 8
    pay_len = np.minimum(udp_len - 8, ippay_len - 8)
    plain &= pay_len > 0

    arenas = [data]
    offs_all = [pay_off[plain]]
    lens_all = [pay_len[plain]]
    tss_all = [tss[plain]]

    # fragmented datagrams: reassemble (python loop over fragments only)
    frag_idx = np.where(ok & (mf | (frag_off > 0)))[0]
    if len(frag_idx):
        ip_id = big(data[ip_off + 4], data[ip_off + 5])
        src = data[ip_off[frag_idx, None] + (12 + np.arange(8))[None, :]]
        keys = [bytes(s) + int(ip_id[i]).to_bytes(2, "big")
                for s, i in zip(src, frag_idx)]
        pend: dict[bytes, dict] = {}
        done_bufs, done_ts = [], []
        for key, i in zip(keys, frag_idx):
            st = pend.setdefault(key, {"parts": [], "total": -1, "got": 0})
            fo, ln = int(frag_off[i]), int(ippay_len[i])
            st["parts"].append(
                (fo, data[ippay_off[i]:ippay_off[i] + ln]))
            st["got"] += ln
            if not mf[i]:
                st["total"] = fo + ln
            if st["total"] >= 0 and st["got"] >= st["total"]:
                buf = np.zeros(st["total"], np.uint8)
                for fo2, chunk in st["parts"]:
                    buf[fo2:fo2 + len(chunk)] = chunk
                ul = (int(buf[4]) << 8) | int(buf[5])
                done_bufs.append(buf[8:8 + max(ul - 8, 0)])
                done_ts.append(tss[i])
                del pend[key]
        if done_bufs:
            frag_arena = np.concatenate(done_bufs)
            flens = np.asarray([len(b) for b in done_bufs], np.int64)
            foffs = np.concatenate([[0], np.cumsum(flens)[:-1]])
            arenas.append(frag_arena)
            base = len(data)
            offs_all.append(foffs + base)
            lens_all.append(flens)
            tss_all.append(np.asarray(done_ts, np.float64))

    arena = np.concatenate(arenas) if len(arenas) > 1 else data
    return _group_by_size(
        arena,
        np.concatenate(offs_all).astype(np.int64),
        np.concatenate(lens_all).astype(np.int64),
        np.concatenate(tss_all),
    )


def write_pcap_udp(
    path: str,
    packets: list[tuple[float, bytes]],
    *,
    src_port: int = 7502,
    dst_port: int = 7502,
    mtu: int | None = None,
) -> None:
    """Write UDP payloads to a classic pcap (test fixtures / exports).

    With ``mtu`` set (e.g. 1500), datagrams whose IP length exceeds it are
    emitted as IPv4 fragments — exactly what real captures of Ouster lidar
    packets look like (12-25 KB datagrams over 1500-byte Ethernet).
    """
    eth = b"\x00" * 12 + struct.pack(">H", ETH_IPV4)

    def ip_hdr(total: int, ip_id: int, flags_frag: int) -> bytes:
        return struct.pack(
            ">BBHHHBBH4s4s", 0x45, 0, total, ip_id, flags_frag, 64,
            PROTO_UDP, 0, bytes([127, 0, 0, 1]), bytes([127, 0, 0, 1]))

    with open(path, "wb") as f:
        f.write(struct.pack("<IHHiIII", MAGIC_US, 2, 4, 0, 0, 65535, 1))
        ip_id = 1
        for ts, payload in packets:
            sec = int(ts)
            usec = int((ts - sec) * 1e6)
            udp = struct.pack(">HHHH", src_port, dst_port,
                              len(payload) + 8, 0) + payload
            if mtu is None or 20 + len(udp) <= mtu:
                frame = eth + ip_hdr(20 + len(udp), ip_id, 0) + udp
                f.write(struct.pack("<IIII", sec, usec, len(frame),
                                    len(frame)))
                f.write(frame)
            else:
                # fragment the IP payload on 8-byte boundaries
                chunk = ((mtu - 20) // 8) * 8
                off = 0
                while off < len(udp):
                    part = udp[off:off + chunk]
                    last = off + len(part) >= len(udp)
                    flags_frag = (0 if last else 0x2000) | (off // 8)
                    frame = eth + ip_hdr(20 + len(part), ip_id,
                                         flags_frag) + part
                    f.write(struct.pack("<IIII", sec, usec, len(frame),
                                        len(frame)))
                    f.write(frame)
                    off += len(part)
            ip_id = (ip_id + 1) & 0xFFFF
