"""Host-side IO: metadata, pcap, packets, ROS bags, pose formats (copies
of ``ptudes_tpu.io``'s modules)."""
from . import metadata, packets, pcap, poses, rosbag, sources

__all__ = ["metadata", "packets", "pcap", "poses", "rosbag", "sources"]
