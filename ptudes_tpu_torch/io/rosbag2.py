"""Minimal ROS2 ``.db3`` bag reader — pure Python, stdlib sqlite3 only.

A copy of ``ptudes_tpu.io.rosbag2`` for the PyTorch port, which imports
nothing of the JAX package; the names and behaviour are the same.

The reference reads ROS1 *and* ROS2 bags through ``rosbags.AnyReader``
(``src/ptudes/bag.py:8,41,110``); this module covers the ROS2 side for the
message types the pipeline needs: Ouster raw ``PacketMsg`` (uint8[] buf)
and ``sensor_msgs/msg/Imu``, serialized as CDR (the only serialization
rosbag2 uses in practice).

Storage model (rosbag2 sqlite3 plugin): a bag is a DIRECTORY containing
``metadata.yaml`` + one or more ``*.db3`` files, each with tables

    topics  (id, name, type, serialization_format, offered_qos_profiles)
    messages(id, topic_id, timestamp, data)

A bare ``*.db3`` file is accepted too.

CDR notes (XCDR1, little-endian): 4-byte encapsulation header
``00 01 00 00``, then fields aligned relative to the payload start;
strings are u32 length INCLUDING the NUL terminator, followed by bytes.
"""
from __future__ import annotations

import os
import sqlite3
import struct
from dataclasses import dataclass
from typing import Iterator

from .rosbag import BagMessage

# ROS2 spellings of the Ouster packet message type
OUSTER_PACKETMSG_TYPES = (
    "ouster_ros/msg/PacketMsg",
    "ouster_sensor_msgs/msg/PacketMsg",
    "ouster_msgs/msg/PacketMsg",
)


def is_rosbag2(path: str) -> bool:
    p = str(path)
    if p.endswith(".db3"):
        return True
    return os.path.isdir(p) and (
        os.path.isfile(os.path.join(p, "metadata.yaml"))
        or any(f.endswith(".db3") for f in os.listdir(p))
    )


def _db3_files(path: str) -> list[str]:
    if os.path.isfile(path):
        return [path]
    return sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.endswith(".db3"))


@dataclass
class Connection2:
    conn_id: int
    topic: str
    msgtype: str
    md5sum: str = ""  # ROS2 has no md5; kept for Connection API parity


class Rosbag2Reader:
    """Stream messages from a rosbag2 directory (or bare .db3 files)."""

    def __init__(self, paths: str | list[str]):
        self.paths = [paths] if isinstance(paths, str) else list(paths)

    def scan_connections(self) -> list[Connection2]:
        out: dict[str, Connection2] = {}
        for path in self.paths:
            for db in _db3_files(path):
                con = sqlite3.connect(f"file:{db}?mode=ro", uri=True)
                try:
                    for tid, name, typ in con.execute(
                            "SELECT id, name, type FROM topics"):
                        out.setdefault(
                            name, Connection2(conn_id=tid, topic=name,
                                              msgtype=typ))
                finally:
                    con.close()
        return list(out.values())

    def messages(
        self, topics: list[str] | None = None
    ) -> Iterator[BagMessage]:
        for path in self.paths:
            for db in _db3_files(path):
                con = sqlite3.connect(f"file:{db}?mode=ro", uri=True)
                try:
                    tmap = {tid: (name, typ) for tid, name, typ in
                            con.execute("SELECT id, name, type FROM topics")}
                    sel = [tid for tid, (name, _) in tmap.items()
                           if not topics or name in topics]
                    if not sel:
                        continue
                    q = ("SELECT topic_id, timestamp, data FROM messages "
                         f"WHERE topic_id IN ({','.join('?' * len(sel))}) "
                         "ORDER BY timestamp")
                    for tid, ts, data in con.execute(q, sel):
                        name, typ = tmap[tid]
                        yield BagMessage(topic=name, msgtype=typ, md5sum="",
                                         ts_ns=int(ts), raw=bytes(data))
                finally:
                    con.close()


# --- CDR deserializers ------------------------------------------------------

def cdr_parse_packetmsg(raw: bytes) -> bytes:
    """PacketMsg { uint8[] buf } in CDR: 4B encapsulation + u32 len + data."""
    (n,) = struct.unpack_from("<I", raw, 4)
    return raw[8:8 + n]


def cdr_parse_imu_msg(raw: bytes) -> tuple[float, tuple, tuple]:
    """sensor_msgs/msg/Imu in CDR ->
    (ts_sec, linear_acceleration, angular_velocity)."""
    pos = 4                                   # skip encapsulation header
    sec, nanosec = struct.unpack_from("<iI", raw, pos)
    pos += 8
    (slen,) = struct.unpack_from("<I", raw, pos)
    pos += 4 + slen                           # frame_id incl. NUL
    pos = (pos - 4 + 7) // 8 * 8 + 4          # align 8 rel. to payload start
    pos += 4 * 8 + 9 * 8                      # orientation + covariance
    av = struct.unpack_from("<3d", raw, pos)
    pos += 3 * 8 + 9 * 8                      # angular velocity + covariance
    la = struct.unpack_from("<3d", raw, pos)
    return sec + nanosec * 1e-9, la, av


# --- writers (test fixtures) ------------------------------------------------

def cdr_serialize_packetmsg(buf: bytes) -> bytes:
    return b"\x00\x01\x00\x00" + struct.pack("<I", len(buf)) + buf


def cdr_serialize_imu_msg(ts_sec: float, lacc, avel,
                          frame_id: str = "imu") -> bytes:
    sec = int(ts_sec)
    nanosec = int(round((ts_sec - sec) * 1e9))
    fid = frame_id.encode() + b"\x00"
    out = struct.pack("<iI", sec, nanosec)
    out += struct.pack("<I", len(fid)) + fid
    pad = (-(len(out))) % 8                   # align doubles rel. to payload
    out += b"\x00" * pad
    out += struct.pack("<4d", 0, 0, 0, 1) + b"\x00" * 72
    out += struct.pack("<3d", *avel) + b"\x00" * 72
    out += struct.pack("<3d", *lacc) + b"\x00" * 72
    return b"\x00\x01\x00\x00" + out


def write_simple_bag2(
    path: str,
    messages: list[tuple[str, str, int, bytes]],
) -> None:
    """Write a minimal rosbag2 directory (sqlite3 + metadata.yaml).

    messages: list of (topic, msgtype, ts_ns, cdr_raw).
    """
    os.makedirs(path, exist_ok=True)
    name = os.path.basename(os.path.normpath(path))
    db = os.path.join(path, f"{name}_0.db3")
    if os.path.exists(db):
        os.remove(db)
    con = sqlite3.connect(db)
    con.execute(
        "CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT, type TEXT,"
        " serialization_format TEXT, offered_qos_profiles TEXT)")
    con.execute(
        "CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER,"
        " timestamp INTEGER, data BLOB)")
    topics: dict[str, int] = {}
    for topic, msgtype, _, _ in messages:
        if topic not in topics:
            tid = len(topics) + 1
            topics[topic] = tid
            con.execute("INSERT INTO topics VALUES (?,?,?,?,?)",
                        (tid, topic, msgtype, "cdr", ""))
    for i, (topic, _, ts_ns, raw) in enumerate(messages):
        con.execute("INSERT INTO messages VALUES (?,?,?,?)",
                    (i + 1, topics[topic], ts_ns, raw))
    con.commit()
    con.close()
    with open(os.path.join(path, "metadata.yaml"), "w") as f:
        f.write(
            "rosbag2_bagfile_information:\n"
            "  version: 4\n"
            "  storage_identifier: sqlite3\n"
            f"  relative_file_paths:\n    - {os.path.basename(db)}\n"
            f"  message_count: {len(messages)}\n")
