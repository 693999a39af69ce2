"""Messenger — the framework's wire layer (src/msg/, src/msg/async/).

The reference's Messenger is a connection-oriented dispatcher fabric:
daemons create a messenger, bind, register Dispatchers, and exchange
typed Messages over framed protocols (ProtocolV2: banner, segmented
frames, crc or secure mode).  This package re-renders that contract
small and async-native:

- ``Message`` subclasses declare a type id + payload encode/decode
  (the ECMsgTypes/MOSDPing/MOSDMap analog, src/osd/ECMsgTypes.h).
- ``Messenger`` owns an asyncio loop on a background thread, binds a
  TCP listener, and dispatches inbound messages to registered
  ``Dispatcher``s (Messenger::add_dispatcher_head, ms_dispatch).
- Frames are length-prefixed with crc32c over header and payload
  (ProtocolV2 crc mode; secure mode is out of scope — transport
  security would wrap the socket, not the frame format).

Device note: this layer is deliberately host-only CPU code, frame
crcs included (``native.ceph_crc32c``).  The messenger carries
control-plane and shard-IO traffic between *processes/hosts*, exactly
the role the reference's AsyncMessenger plays beneath the OSDs; the
card sees the shard bytes only once they have landed in a store.  Its
wire is the JAX package's, byte for byte: a messenger of either
package talks to the other's.
"""

from .faults import FaultInjector, FaultRule, build_msgr_perf
from .stack import NetworkStack, build_stack_perf, stack_perf_dump
from .message import (
    MCommand,
    MECSubRead,
    MLog,
    MMonElection,
    MMonPaxos,
    MECSubReadReply,
    MECSubWrite,
    MECSubWriteReply,
    MOSDBackoff,
    MOSDMap,
    MOSDOp,
    MOSDOpReply,
    MOSDRepOp,
    MOSDRepOpReply,
    MPGActivate,
    MPGLogReply,
    MPGLogReq,
    MPGNotify,
    MPGPull,
    MPGPush,
    MPGPushReply,
    MPGQuery,
    MPing,
    MRepScrub,
    MScrubCommand,
    MScrubMap,
    MWatchNotify,
    MWatchNotifyAck,
    Message,
    MessageError,
    register_message,
)
from .messenger import Connection, Dispatcher, Messenger

__all__ = [
    "Connection",
    "Dispatcher",
    "FaultInjector",
    "FaultRule",
    "MCommand",
    "MECSubRead",
    "MLog",
    "MECSubReadReply",
    "MECSubWrite",
    "MECSubWriteReply",
    "MMonElection",
    "MMonPaxos",
    "MOSDBackoff",
    "MOSDMap",
    "MOSDOp",
    "MOSDOpReply",
    "MOSDRepOp",
    "MOSDRepOpReply",
    "MPGActivate",
    "MPGLogReply",
    "MPGLogReq",
    "MPGNotify",
    "MPGPull",
    "MPGPush",
    "MPGPushReply",
    "MPGQuery",
    "MPing",
    "MRepScrub",
    "MScrubCommand",
    "MScrubMap",
    "MWatchNotify",
    "MWatchNotifyAck",
    "Message",
    "MessageError",
    "Messenger",
    "NetworkStack",
    "build_msgr_perf",
    "build_stack_perf",
    "register_message",
    "stack_perf_dump",
]
