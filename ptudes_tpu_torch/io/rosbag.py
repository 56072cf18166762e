"""Minimal ROS1 ``.bag`` (format 2.0) reader — pure Python, stdlib only.

A copy of ``ptudes_tpu.io.rosbag`` for the PyTorch port, which imports
nothing of the JAX package; the names and behaviour are the same.

Replaces the reference's ``rosbags.highlevel.AnyReader`` dependency
(``src/ptudes/bag.py:8,41,110``) for the message types the pipeline needs:
``ouster_ros/msg/PacketMsg`` (raw lidar/IMU packet buffers) and
``sensor_msgs/msg/Imu``. Supports uncompressed, bz2- and lz4-compressed
chunks (lz4 frame decoding via the dependency-free ``io.lz4f`` codec).

Format reference: the public ROS bag 2.0 spec — records of
(header_len, header fields, data_len, data), with Chunk records embedding
Connection and MessageData records.
"""
from __future__ import annotations

import bz2

from . import lz4f
import struct
from dataclasses import dataclass
from typing import Iterator

OP_BAG_HEADER = 0x03
OP_CHUNK = 0x05
OP_CONNECTION = 0x07
OP_MESSAGE_DATA = 0x02
OP_INDEX_DATA = 0x04
OP_CHUNK_INFO = 0x06

OUSTER_PACKETMSG_MD5 = "4f7b5949e76f86d01e96b0e33ba9b5e3"
"""Ouster ROS PacketMsg type MD5 (reference ``src/ptudes/bag.py:19``)."""


def _parse_header(buf: bytes) -> dict[bytes, bytes]:
    fields = {}
    pos = 0
    while pos < len(buf):
        (flen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        item = buf[pos:pos + flen]
        pos += flen
        k, _, v = item.partition(b"=")
        fields[k] = v
    return fields


@dataclass
class Connection:
    conn_id: int
    topic: str
    msgtype: str = ""
    md5sum: str = ""


@dataclass
class BagMessage:
    topic: str
    msgtype: str
    md5sum: str
    ts_ns: int
    raw: bytes


class RosbagReader:
    """Stream messages from one or more ROS1 bags in time order per file."""

    def __init__(self, paths: str | list[str]):
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        self.connections: dict[int, Connection] = {}
        # topics discovered during iteration (populated lazily/fully on scan)
        self._scanned = False

    def _iter_records(self, f) -> Iterator[tuple[dict, bytes]]:
        while True:
            head = f.read(4)
            if len(head) < 4:
                return
            (hlen,) = struct.unpack("<I", head)
            header = _parse_header(f.read(hlen))
            (dlen,) = struct.unpack("<I", f.read(4))
            data = f.read(dlen)
            yield header, data

    def _iter_chunk(self, data: bytes) -> Iterator[tuple[dict, bytes]]:
        pos = 0
        n = len(data)
        while pos + 4 <= n:
            (hlen,) = struct.unpack_from("<I", data, pos)
            pos += 4
            header = _parse_header(data[pos:pos + hlen])
            pos += hlen
            (dlen,) = struct.unpack_from("<I", data, pos)
            pos += 4
            yield header, data[pos:pos + dlen]
            pos += dlen

    def messages(
        self, topics: list[str] | None = None
    ) -> Iterator[BagMessage]:
        for path in self.paths:
            with open(path, "rb") as f:
                magic = f.readline()
                if not magic.startswith(b"#ROSBAG V2.0"):
                    raise ValueError(f"{path}: not a ROS1 bag v2.0")
                for header, data in self._iter_records(f):
                    op = header.get(b"op", b"\x00")[0]
                    if op == OP_CONNECTION:
                        self._add_connection(header, data)
                    elif op == OP_CHUNK:
                        comp = header.get(b"compression", b"none").decode()
                        if comp == "bz2":
                            data = bz2.decompress(data)
                        elif comp == "lz4":
                            data = lz4f.frame_decompress(data)
                        elif comp != "none":
                            raise ValueError(f"unknown compression {comp}")
                        for h2, d2 in self._iter_chunk(data):
                            op2 = h2.get(b"op", b"\x00")[0]
                            if op2 == OP_CONNECTION:
                                self._add_connection(h2, d2)
                            elif op2 == OP_MESSAGE_DATA:
                                (cid,) = struct.unpack("<I", h2[b"conn"])
                                (t,) = struct.unpack("<Q", h2[b"time"])
                                conn = self.connections.get(cid)
                                if conn is None:
                                    continue
                                if topics and conn.topic not in topics:
                                    continue
                                yield BagMessage(
                                    topic=conn.topic,
                                    msgtype=conn.msgtype,
                                    md5sum=conn.md5sum,
                                    ts_ns=t,
                                    raw=d2,
                                )

    def _add_connection(self, header: dict, data: bytes) -> None:
        (cid,) = struct.unpack("<I", header[b"conn"])
        topic = header.get(b"topic", b"").decode()
        sub = _parse_header(data)
        self.connections[cid] = Connection(
            conn_id=cid,
            topic=topic,
            msgtype=sub.get(b"type", b"").decode(),
            md5sum=sub.get(b"md5sum", b"").decode(),
        )

    def scan_connections(self) -> list[Connection]:
        """Discover every connection record in each file.

        Fast path: seek to ``index_pos`` from the bag header — rosbag
        record writes the full connection-record section there after the
        chunks. Fallback (index_pos == 0, e.g. an unindexed/crashed bag):
        scan ALL records including inside every chunk — a topic whose
        first message lands in a later chunk must still be discovered.
        """
        for path in self.paths:
            with open(path, "rb") as f:
                f.readline()
                start = f.tell()
                recs = self._iter_records(f)
                try:
                    header, _ = next(recs)
                except StopIteration:
                    continue
                index_pos = 0
                if (header.get(b"op", b"\x00")[0] == OP_BAG_HEADER
                        and b"index_pos" in header):
                    (index_pos,) = struct.unpack("<Q", header[b"index_pos"])

                if index_pos:
                    f.seek(index_pos)
                    for h2, d2 in self._iter_records(f):
                        if h2.get(b"op", b"\x00")[0] == OP_CONNECTION:
                            self._add_connection(h2, d2)
                    continue

                f.seek(start)
                for h, data in self._iter_records(f):
                    op = h.get(b"op", b"\x00")[0]
                    if op == OP_CONNECTION:
                        self._add_connection(h, data)
                    elif op == OP_CHUNK:
                        comp = h.get(b"compression", b"none").decode()
                        if comp == "bz2":
                            data = bz2.decompress(data)
                        elif comp == "lz4":
                            data = lz4f.frame_decompress(data)
                        elif comp != "none":
                            continue
                        for h2, d2 in self._iter_chunk(data):
                            if h2.get(b"op", b"\x00")[0] == OP_CONNECTION:
                                self._add_connection(h2, d2)
        return list(self.connections.values())


# --- message deserializers ------------------------------------------------

def parse_packetmsg(raw: bytes) -> bytes:
    """ouster_ros/msg/PacketMsg: uint8[] buf -> the raw UDP payload."""
    (n,) = struct.unpack_from("<I", raw, 0)
    return raw[4:4 + n]


def parse_imu_msg(raw: bytes) -> tuple[float, tuple, tuple]:
    """sensor_msgs/msg/Imu -> (ts_sec, linear_acceleration, angular_velocity).

    Layout: Header (u32 seq, u32 sec, u32 nsec, string frame_id),
    quaternion 4xf64 + cov 9xf64, angular_velocity 3xf64 + cov 9xf64,
    linear_acceleration 3xf64 + cov 9xf64.
    """
    pos = 4
    sec, nsec = struct.unpack_from("<II", raw, pos)
    pos += 8
    (slen,) = struct.unpack_from("<I", raw, pos)
    pos += 4 + slen
    pos += 4 * 8 + 9 * 8          # orientation + cov
    av = struct.unpack_from("<3d", raw, pos)
    pos += 3 * 8 + 9 * 8          # angular velocity + cov
    la = struct.unpack_from("<3d", raw, pos)
    return sec + nsec * 1e-9, la, av


def serialize_imu_msg(ts_sec: float, lacc, avel, frame_id: str = "imu") -> bytes:
    """Inverse of :func:`parse_imu_msg` (test fixtures)."""
    sec = int(ts_sec)
    nsec = int(round((ts_sec - sec) * 1e9))
    fid = frame_id.encode()
    out = struct.pack("<III", 0, sec, nsec)
    out += struct.pack("<I", len(fid)) + fid
    out += struct.pack("<4d", 0, 0, 0, 1) + b"\x00" * 72
    out += struct.pack("<3d", *avel) + b"\x00" * 72
    out += struct.pack("<3d", *lacc) + b"\x00" * 72
    return out


def write_simple_bag(
    path: str,
    messages: list[tuple[str, str, str, int, bytes]],
    *,
    messages_per_chunk: int | None = None,
    write_index: bool = False,
    compression: str = "none",
) -> None:
    """Write a minimal ROS1 bag (test fixtures). ``compression``:
    "none", "bz2" or "lz4" (chunk payloads compressed like rosbag
    record's --bz2/--lz4 output; lz4 via the stdlib-only io.lz4f).

    messages: list of (topic, msgtype, md5sum, ts_ns, raw).

    ``messages_per_chunk`` splits the stream into several chunks; each
    topic's connection record is embedded only in the chunk where the
    topic FIRST appears (rosbag record behavior). ``write_index`` appends
    the trailing connection-record section and points the bag header's
    ``index_pos`` at it (what real indexed bags have).
    """
    def rec(header_fields: dict[bytes, bytes], data: bytes) -> bytes:
        hdr = b"".join(
            struct.pack("<I", len(k) + 1 + len(v)) + k + b"=" + v
            for k, v in header_fields.items()
        )
        return struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(data)) + data

    topics = {}
    for topic, msgtype, md5, _, _ in messages:
        topics.setdefault(topic, (msgtype, md5))
    conn_ids = {t: i for i, t in enumerate(topics)}

    def conn_rec(topic: str) -> bytes:
        msgtype, md5 = topics[topic]
        conn_data = b"".join(
            struct.pack("<I", len(k) + 1 + len(v)) + k + b"=" + v
            for k, v in {
                b"topic": topic.encode(),
                b"type": msgtype.encode(),
                b"md5sum": md5.encode(),
                b"message_definition": b"",
            }.items()
        )
        return rec(
            {b"op": bytes([OP_CONNECTION]),
             b"conn": struct.pack("<I", conn_ids[topic]),
             b"topic": topic.encode()},
            conn_data,
        )

    per = messages_per_chunk or len(messages) or 1
    chunks = []
    seen: set[str] = set()
    for c0 in range(0, max(len(messages), 1), per):
        chunk = b""
        for topic, msgtype, md5, ts_ns, raw in messages[c0:c0 + per]:
            if topic not in seen:
                seen.add(topic)
                chunk += conn_rec(topic)
            chunk += rec(
                {b"op": bytes([OP_MESSAGE_DATA]),
                 b"conn": struct.pack("<I", conn_ids[topic]),
                 b"time": struct.pack("<Q", ts_ns)},
                raw,
            )
        chunks.append(chunk)

    header_rec_placeholder = rec(
        {b"op": bytes([OP_BAG_HEADER]),
         b"index_pos": struct.pack("<Q", 0),
         b"conn_count": struct.pack("<I", len(topics)),
         b"chunk_count": struct.pack("<I", len(chunks))},
        b" " * 4096,  # spec pads the header record
    )
    def pack_chunk(chunk: bytes) -> bytes:
        if compression == "bz2":
            payload = bz2.compress(chunk)
        elif compression == "lz4":
            payload = lz4f.frame_compress(chunk)
        elif compression == "none":
            payload = chunk
        else:
            raise ValueError(f"unknown compression {compression!r}")
        return rec({b"op": bytes([OP_CHUNK]),
                    b"compression": compression.encode(),
                    b"size": struct.pack("<I", len(chunk))},
                   payload)

    body = b"".join(pack_chunk(chunk) for chunk in chunks)
    magic = b"#ROSBAG V2.0\n"
    index_pos = 0
    if write_index:
        index_pos = len(magic) + len(header_rec_placeholder) + len(body)
    header_rec = rec(
        {b"op": bytes([OP_BAG_HEADER]),
         b"index_pos": struct.pack("<Q", index_pos),
         b"conn_count": struct.pack("<I", len(topics)),
         b"chunk_count": struct.pack("<I", len(chunks))},
        b" " * 4096,
    )
    assert len(header_rec) == len(header_rec_placeholder)
    with open(path, "wb") as f:
        f.write(magic)
        f.write(header_rec)
        f.write(body)
        if write_index:
            for topic in topics:
                f.write(conn_rec(topic))
