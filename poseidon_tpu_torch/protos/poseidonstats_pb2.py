# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: poseidonstats.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13poseidonstats.proto\x12\x05stats\"\xf2\x01\n\tNodeStats\x12\x10\n\x08hostname\x18\x01 \x01(\t\x12\x11\n\ttimestamp\x18\x02 \x01(\x04\x12\x17\n\x0f\x63pu_allocatable\x18\x03 \x01(\x03\x12\x14\n\x0c\x63pu_capacity\x18\x04 \x01(\x03\x12\x17\n\x0f\x63pu_reservation\x18\x05 \x01(\x01\x12\x17\n\x0f\x63pu_utilization\x18\x06 \x01(\x01\x12\x17\n\x0fmem_allocatable\x18\x07 \x01(\x03\x12\x14\n\x0cmem_capacity\x18\x08 \x01(\x03\x12\x17\n\x0fmem_reservation\x18\t \x01(\x01\x12\x17\n\x0fmem_utilization\x18\n \x01(\x01\"Q\n\x11NodeStatsResponse\x12*\n\x04type\x18\x01 \x01(\x0e\x32\x1c.stats.NodeStatsResponseType\x12\x10\n\x08hostname\x18\x02 \x01(\t\"\x92\x04\n\x08PodStats\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12\x10\n\x08hostname\x18\x03 \x01(\t\x12\x11\n\tcpu_limit\x18\x04 \x01(\x03\x12\x13\n\x0b\x63pu_request\x18\x05 \x01(\x03\x12\x11\n\tcpu_usage\x18\x06 \x01(\x03\x12\x11\n\tmem_limit\x18\x07 \x01(\x03\x12\x13\n\x0bmem_request\x18\x08 \x01(\x03\x12\x11\n\tmem_usage\x18\t \x01(\x03\x12\x0f\n\x07mem_rss\x18\n \x01(\x03\x12\x11\n\tmem_cache\x18\x0b \x01(\x03\x12\x17\n\x0fmem_working_set\x18\x0c \x01(\x03\x12\x17\n\x0fmem_page_faults\x18\r \x01(\x03\x12\x1c\n\x14mem_page_faults_rate\x18\x0e \x01(\x01\x12\x19\n\x11major_page_faults\x18\x0f \x01(\x03\x12\x1e\n\x16major_page_faults_rate\x18\x10 \x01(\x01\x12\x0e\n\x06net_rx\x18\x11 \x01(\x03\x12\x15\n\rnet_rx_errors\x18\x12 \x01(\x03\x12\x1a\n\x12net_rx_errors_rate\x18\x13 \x01(\x01\x12\x13\n\x0bnet_rx_rate\x18\x14 \x01(\x01\x12\x0e\n\x06net_tx\x18\x15 \x01(\x03\x12\x15\n\rnet_tx_errors\x18\x16 \x01(\x03\x12\x1a\n\x12net_tx_errors_rate\x18\x17 \x01(\x01\x12\x13\n\x0bnet_tx_rate\x18\x18 \x01(\x01\"^\n\x10PodStatsResponse\x12)\n\x04type\x18\x01 \x01(\x0e\x32\x1b.stats.PodStatsResponseType\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x11\n\tnamespace\x18\x03 \x01(\t*>\n\x15NodeStatsResponseType\x12\x11\n\rNODE_STATS_OK\x10\x00\x12\x12\n\x0eNODE_NOT_FOUND\x10\x01*;\n\x14PodStatsResponseType\x12\x10\n\x0cPOD_STATS_OK\x10\x00\x12\x11\n\rPOD_NOT_FOUND\x10\x01\x32\x98\x01\n\rPoseidonStats\x12\x44\n\x10ReceiveNodeStats\x12\x10.stats.NodeStats\x1a\x18.stats.NodeStatsResponse\"\x00(\x01\x30\x01\x12\x41\n\x0fReceivePodStats\x12\x0f.stats.PodStats\x1a\x17.stats.PodStatsResponse\"\x00(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'poseidonstats_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NODESTATSRESPONSETYPE._serialized_start=987
  _NODESTATSRESPONSETYPE._serialized_end=1049
  _PODSTATSRESPONSETYPE._serialized_start=1051
  _PODSTATSRESPONSETYPE._serialized_end=1110
  _NODESTATS._serialized_start=31
  _NODESTATS._serialized_end=273
  _NODESTATSRESPONSE._serialized_start=275
  _NODESTATSRESPONSE._serialized_end=356
  _PODSTATS._serialized_start=359
  _PODSTATS._serialized_end=889
  _PODSTATSRESPONSE._serialized_start=891
  _PODSTATSRESPONSE._serialized_end=985
  _POSEIDONSTATS._serialized_start=1113
  _POSEIDONSTATS._serialized_end=1265
# @@protoc_insertion_point(module_scope)
