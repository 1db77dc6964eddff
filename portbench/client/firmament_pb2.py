# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: firmament.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0f\x66irmament.proto\x12\tfirmament\"\x8d\x01\n\x0eResourceVector\x12\x11\n\tcpu_cores\x18\x01 \x01(\x02\x12\x0e\n\x06ram_bw\x18\x02 \x01(\x04\x12\x0f\n\x07ram_cap\x18\x03 \x01(\x04\x12\x0f\n\x07\x64isk_bw\x18\x04 \x01(\x04\x12\x10\n\x08\x64isk_cap\x18\x05 \x01(\x04\x12\x11\n\tnet_tx_bw\x18\x06 \x01(\x04\x12\x11\n\tnet_rx_bw\x18\x07 \x01(\x04\"#\n\x05Label\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\"\xb1\x01\n\rLabelSelector\x12\x33\n\x04type\x18\x01 \x01(\x0e\x32%.firmament.LabelSelector.SelectorType\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\x0e\n\x06values\x18\x03 \x03(\t\"N\n\x0cSelectorType\x12\n\n\x06IN_SET\x10\x00\x12\x0e\n\nNOT_IN_SET\x10\x01\x12\x0e\n\nEXISTS_KEY\x10\x02\x12\x12\n\x0eNOT_EXISTS_KEY\x10\x03\"\xb4\x03\n\x13ReferenceDescriptor\x12\n\n\x02id\x18\x01 \x01(\x0c\x12:\n\x04type\x18\x02 \x01(\x0e\x32,.firmament.ReferenceDescriptor.ReferenceType\x12<\n\x05scope\x18\x03 \x01(\x0e\x32-.firmament.ReferenceDescriptor.ReferenceScope\x12\x19\n\x11non_deterministic\x18\x04 \x01(\x08\x12\x0c\n\x04size\x18\x05 \x01(\x04\x12\x10\n\x08location\x18\x06 \x01(\t\x12\x13\n\x0binline_data\x18\x07 \x01(\x0c\x12\x16\n\x0eproducing_task\x18\x08 \x01(\x04\x12\x17\n\x0ftime_to_compute\x18\t \x01(\x04\x12\x0f\n\x07version\x18\n \x01(\x04\"Z\n\rReferenceType\x12\r\n\tTOMBSTONE\x10\x00\x12\n\n\x06\x46UTURE\x10\x01\x12\x0c\n\x08\x43ONCRETE\x10\x02\x12\n\n\x06STREAM\x10\x03\x12\t\n\x05VALUE\x10\x04\x12\t\n\x05\x45RROR\x10\x05\")\n\x0eReferenceScope\x12\n\n\x06PUBLIC\x10\x00\x12\x0b\n\x07PRIVATE\x10\x01\"\xa8\x01\n\x0fTaskFinalReport\x12\x0f\n\x07task_id\x18\x01 \x01(\x04\x12\x12\n\nstart_time\x18\x02 \x01(\x04\x12\x13\n\x0b\x66inish_time\x18\x03 \x01(\x04\x12\x14\n\x0cinstructions\x18\x04 \x01(\x04\x12\x0e\n\x06\x63ycles\x18\x05 \x01(\x04\x12\x10\n\x08llc_refs\x18\x06 \x01(\x04\x12\x12\n\nllc_misses\x18\x07 \x01(\x04\x12\x0f\n\x07runtime\x18\x08 \x01(\x01\"r\n\rWhareMapStats\x12\x10\n\x08num_idle\x18\x01 \x01(\x04\x12\x12\n\nnum_devils\x18\x02 \x01(\x04\x12\x13\n\x0bnum_rabbits\x18\x03 \x01(\x04\x12\x11\n\tnum_sheep\x18\x04 \x01(\x04\x12\x13\n\x0bnum_turtles\x18\x05 \x01(\x04\"v\n\x16\x43oCoInterferenceScores\x12\x15\n\rdevil_penalty\x18\x01 \x01(\r\x12\x16\n\x0erabbit_penalty\x18\x02 \x01(\r\x12\x15\n\rsheep_penalty\x18\x03 \x01(\r\x12\x16\n\x0eturtle_penalty\x18\x04 \x01(\r\"\x88\n\n\x0eTaskDescriptor\x12\x0b\n\x03uid\x18\x01 \x01(\x04\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x32\n\x05state\x18\x03 \x01(\x0e\x32#.firmament.TaskDescriptor.TaskState\x12\x0e\n\x06job_id\x18\x04 \x01(\t\x12\r\n\x05index\x18\x05 \x01(\x04\x12\x34\n\x0c\x64\x65pendencies\x18\x06 \x03(\x0b\x32\x1e.firmament.ReferenceDescriptor\x12/\n\x07outputs\x18\x07 \x03(\x0b\x32\x1e.firmament.ReferenceDescriptor\x12\x0e\n\x06\x62inary\x18\x08 \x01(\t\x12\x0c\n\x04\x61rgs\x18\t \x03(\t\x12*\n\x07spawned\x18\n \x03(\x0b\x32\x19.firmament.TaskDescriptor\x12\x1d\n\x15scheduled_to_resource\x18\x0b \x01(\t\x12\x1f\n\x17last_heartbeat_location\x18\x0c \x01(\t\x12\x1b\n\x13last_heartbeat_time\x18\r \x01(\x04\x12\x14\n\x0c\x64\x65legated_to\x18\x0e \x01(\t\x12\x16\n\x0e\x64\x65legated_from\x18\x0f \x01(\t\x12\x13\n\x0bsubmit_time\x18\x10 \x01(\x04\x12\x12\n\nstart_time\x18\x11 \x01(\x04\x12\x13\n\x0b\x66inish_time\x18\x12 \x01(\x04\x12\x1e\n\x16total_unscheduled_time\x18\x13 \x01(\x04\x12\x16\n\x0etotal_run_time\x18\x14 \x01(\x04\x12\x19\n\x11relative_deadline\x18\x15 \x01(\x04\x12\x19\n\x11\x61\x62solute_deadline\x18\x16 \x01(\x04\x12\x0c\n\x04port\x18\x17 \x01(\x04\x12\x12\n\ninput_size\x18\x18 \x01(\x04\x12\x17\n\x0finject_task_lib\x18\x19 \x01(\x08\x12\x33\n\x10resource_request\x18\x1a \x01(\x0b\x32\x19.firmament.ResourceVector\x12\x10\n\x08priority\x18\x1b \x01(\r\x12\x35\n\ttask_type\x18\x1c \x01(\x0e\x32\".firmament.TaskDescriptor.TaskType\x12\x30\n\x0c\x66inal_report\x18\x1d \x01(\x0b\x32\x1a.firmament.TaskFinalReport\x12\x14\n\x0ctrace_job_id\x18\x1e \x01(\x04\x12\x15\n\rtrace_task_id\x18\x1f \x01(\x04\x12 \n\x06labels\x18  \x03(\x0b\x32\x10.firmament.Label\x12\x31\n\x0flabel_selectors\x18! \x03(\x0b\x32\x18.firmament.LabelSelector\x12.\n\x0cpod_affinity\x18\" \x03(\x0b\x32\x18.firmament.LabelSelector\x12\x33\n\x11pod_anti_affinity\x18# \x03(\x0b\x32\x18.firmament.LabelSelector\"\x93\x01\n\tTaskState\x12\x0b\n\x07\x43REATED\x10\x00\x12\x0c\n\x08\x42LOCKING\x10\x01\x12\x0c\n\x08RUNNABLE\x10\x02\x12\x0c\n\x08\x41SSIGNED\x10\x03\x12\x0b\n\x07RUNNING\x10\x04\x12\r\n\tCOMPLETED\x10\x05\x12\n\n\x06\x46\x41ILED\x10\x06\x12\x0b\n\x07\x41\x42ORTED\x10\x07\x12\r\n\tDELEGATED\x10\x08\x12\x0b\n\x07UNKNOWN\x10\t\"8\n\x08TaskType\x12\t\n\x05SHEEP\x10\x00\x12\n\n\x06RABBIT\x10\x01\x12\t\n\x05\x44\x45VIL\x10\x02\x12\n\n\x06TURTLE\x10\x03\"\x83\x02\n\rJobDescriptor\x12\x0c\n\x04uuid\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x30\n\x05state\x18\x03 \x01(\x0e\x32!.firmament.JobDescriptor.JobState\x12,\n\troot_task\x18\x04 \x01(\x0b\x32\x19.firmament.TaskDescriptor\x12\x12\n\noutput_ids\x18\x05 \x03(\x0c\"b\n\x08JobState\x12\x07\n\x03NEW\x10\x00\x12\x0b\n\x07\x43REATED\x10\x01\x12\x0b\n\x07RUNNING\x10\x02\x12\r\n\tCOMPLETED\x10\x03\x12\n\n\x06\x46\x41ILED\x10\x04\x12\x0b\n\x07\x41\x42ORTED\x10\x05\x12\x0b\n\x07UNKNOWN\x10\x06\"\x9c\n\n\x12ResourceDescriptor\x12\x0c\n\x04uuid\x18\x01 \x01(\t\x12\x15\n\rfriendly_name\x18\x02 \x01(\t\x12\x18\n\x10\x64\x65scriptive_name\x18\x03 \x01(\t\x12:\n\x05state\x18\x04 \x01(\x0e\x32+.firmament.ResourceDescriptor.ResourceState\x12\x15\n\rtask_capacity\x18\x05 \x01(\x04\x12\x16\n\x0elast_heartbeat\x18\x06 \x01(\x04\x12\x38\n\x04type\x18\x07 \x01(\x0e\x32*.firmament.ResourceDescriptor.ResourceType\x12\x13\n\x0bschedulable\x18\x08 \x01(\x08\x12\x1d\n\x15\x63urrent_running_tasks\x18\t \x03(\x04\x12\x1f\n\x17num_running_tasks_below\x18\n \x01(\x04\x12\x17\n\x0fnum_slots_below\x18\x0b \x01(\x04\x12\x36\n\x13\x61vailable_resources\x18\x0c \x01(\x0b\x32\x19.firmament.ResourceVector\x12\x35\n\x12reserved_resources\x18\r \x01(\x0b\x32\x19.firmament.ResourceVector\x12@\n\x1dmin_available_resources_below\x18\x0e \x01(\x0b\x32\x19.firmament.ResourceVector\x12@\n\x1dmax_available_resources_below\x18\x0f \x01(\x0b\x32\x19.firmament.ResourceVector\x12\x41\n\x1emin_unreserved_resources_below\x18\x10 \x01(\x0b\x32\x19.firmament.ResourceVector\x12\x41\n\x1emax_unreserved_resources_below\x18\x11 \x01(\x0b\x32\x19.firmament.ResourceVector\x12\x34\n\x11resource_capacity\x18\x12 \x01(\x0b\x32\x19.firmament.ResourceVector\x12\x31\n\x0fwhare_map_stats\x18\x13 \x01(\x0b\x32\x18.firmament.WhareMapStats\x12\x43\n\x18\x63oco_interference_scores\x18\x14 \x01(\x0b\x32!.firmament.CoCoInterferenceScores\x12\x18\n\x10trace_machine_id\x18\x15 \x01(\x04\x12 \n\x06labels\x18  \x03(\x0b\x32\x10.firmament.Label\"^\n\rResourceState\x12\x14\n\x10RESOURCE_UNKNOWN\x10\x00\x12\x11\n\rRESOURCE_IDLE\x10\x01\x12\x11\n\rRESOURCE_BUSY\x10\x02\x12\x11\n\rRESOURCE_LOST\x10\x03\"\xf0\x01\n\x0cResourceType\x12\x0f\n\x0bRESOURCE_PU\x10\x00\x12\x11\n\rRESOURCE_CORE\x10\x01\x12\x12\n\x0eRESOURCE_CACHE\x10\x02\x12\x10\n\x0cRESOURCE_NIC\x10\x03\x12\x11\n\rRESOURCE_DISK\x10\x04\x12\x10\n\x0cRESOURCE_SSD\x10\x05\x12\x14\n\x10RESOURCE_MACHINE\x10\x06\x12\x14\n\x10RESOURCE_LOGICAL\x10\x07\x12\x16\n\x12RESOURCE_NUMA_NODE\x10\x08\x12\x13\n\x0fRESOURCE_SOCKET\x10\t\x12\x18\n\x14RESOURCE_COORDINATOR\x10\n\"\xa6\x01\n\x1eResourceTopologyNodeDescriptor\x12\x34\n\rresource_desc\x18\x01 \x01(\x0b\x32\x1d.firmament.ResourceDescriptor\x12;\n\x08\x63hildren\x18\x02 \x03(\x0b\x32).firmament.ResourceTopologyNodeDescriptor\x12\x11\n\tparent_id\x18\x03 \x01(\t\"\xa9\x01\n\x0fSchedulingDelta\x12\x0f\n\x07task_id\x18\x01 \x01(\x04\x12\x13\n\x0bresource_id\x18\x02 \x01(\t\x12\x33\n\x04type\x18\x03 \x01(\x0e\x32%.firmament.SchedulingDelta.ChangeType\";\n\nChangeType\x12\x08\n\x04NOOP\x10\x00\x12\t\n\x05PLACE\x10\x01\x12\x0b\n\x07PREEMPT\x10\x02\x12\x0b\n\x07MIGRATE\x10\x03\"\x96\x04\n\tTaskStats\x12\x0f\n\x07task_id\x18\x01 \x01(\x04\x12\x10\n\x08hostname\x18\x02 \x01(\t\x12\x11\n\ttimestamp\x18\x03 \x01(\x04\x12\x11\n\tcpu_limit\x18\x04 \x01(\x03\x12\x13\n\x0b\x63pu_request\x18\x05 \x01(\x03\x12\x11\n\tcpu_usage\x18\x06 \x01(\x03\x12\x11\n\tmem_limit\x18\x07 \x01(\x03\x12\x13\n\x0bmem_request\x18\x08 \x01(\x03\x12\x11\n\tmem_usage\x18\t \x01(\x03\x12\x0f\n\x07mem_rss\x18\n \x01(\x03\x12\x11\n\tmem_cache\x18\x0b \x01(\x03\x12\x17\n\x0fmem_working_set\x18\x0c \x01(\x03\x12\x17\n\x0fmem_page_faults\x18\r \x01(\x03\x12\x1c\n\x14mem_page_faults_rate\x18\x0e \x01(\x01\x12\x19\n\x11major_page_faults\x18\x0f \x01(\x03\x12\x1e\n\x16major_page_faults_rate\x18\x10 \x01(\x01\x12\x0e\n\x06net_rx\x18\x11 \x01(\x03\x12\x15\n\rnet_rx_errors\x18\x12 \x01(\x03\x12\x1a\n\x12net_rx_errors_rate\x18\x13 \x01(\x01\x12\x13\n\x0bnet_rx_rate\x18\x14 \x01(\x01\x12\x0e\n\x06net_tx\x18\x15 \x01(\x03\x12\x15\n\rnet_tx_errors\x18\x16 \x01(\x03\x12\x1a\n\x12net_tx_errors_rate\x18\x17 \x01(\x01\x12\x13\n\x0bnet_tx_rate\x18\x18 \x01(\x01\"k\n\x08\x43puStats\x12\x17\n\x0f\x63pu_allocatable\x18\x01 \x01(\x03\x12\x14\n\x0c\x63pu_capacity\x18\x02 \x01(\x03\x12\x17\n\x0f\x63pu_reservation\x18\x03 \x01(\x01\x12\x17\n\x0f\x63pu_utilization\x18\x04 \x01(\x01\"\xf8\x01\n\rResourceStats\x12\x13\n\x0bresource_id\x18\x01 \x01(\t\x12\x11\n\ttimestamp\x18\x02 \x01(\x04\x12\'\n\ncpus_stats\x18\x03 \x03(\x0b\x32\x13.firmament.CpuStats\x12\x17\n\x0fmem_allocatable\x18\x04 \x01(\x03\x12\x14\n\x0cmem_capacity\x18\x05 \x01(\x03\x12\x17\n\x0fmem_reservation\x18\x06 \x01(\x01\x12\x17\n\x0fmem_utilization\x18\x07 \x01(\x01\x12\x0f\n\x07\x64isk_bw\x18\x08 \x01(\x03\x12\x11\n\tnet_rx_bw\x18\t \x01(\x03\x12\x11\n\tnet_tx_bw\x18\n \x01(\x03\"\x11\n\x0fScheduleRequest\">\n\x10SchedulingDeltas\x12*\n\x06\x64\x65ltas\x18\x01 \x03(\x0b\x32\x1a.firmament.SchedulingDelta\"w\n\x0fTaskDescription\x12\x32\n\x0ftask_descriptor\x18\x01 \x01(\x0b\x32\x19.firmament.TaskDescriptor\x12\x30\n\x0ejob_descriptor\x18\x02 \x01(\x0b\x32\x18.firmament.JobDescriptor\"\x1b\n\x07TaskUID\x12\x10\n\x08task_uid\x18\x01 \x01(\x04\"#\n\x0bResourceUID\x12\x14\n\x0cresource_uid\x18\x01 \x01(\t\"?\n\x15TaskCompletedResponse\x12&\n\x04type\x18\x01 \x01(\x0e\x32\x18.firmament.TaskReplyType\"?\n\x15TaskSubmittedResponse\x12&\n\x04type\x18\x01 \x01(\x0e\x32\x18.firmament.TaskReplyType\"=\n\x13TaskRemovedResponse\x12&\n\x04type\x18\x01 \x01(\x0e\x32\x18.firmament.TaskReplyType\"<\n\x12TaskFailedResponse\x12&\n\x04type\x18\x01 \x01(\x0e\x32\x18.firmament.TaskReplyType\"=\n\x13TaskUpdatedResponse\x12&\n\x04type\x18\x01 \x01(\x0e\x32\x18.firmament.TaskReplyType\";\n\x11NodeAddedResponse\x12&\n\x04type\x18\x01 \x01(\x0e\x32\x18.firmament.NodeReplyType\"=\n\x13NodeRemovedResponse\x12&\n\x04type\x18\x01 \x01(\x0e\x32\x18.firmament.NodeReplyType\"<\n\x12NodeFailedResponse\x12&\n\x04type\x18\x01 \x01(\x0e\x32\x18.firmament.NodeReplyType\"=\n\x13NodeUpdatedResponse\x12&\n\x04type\x18\x01 \x01(\x0e\x32\x18.firmament.NodeReplyType\";\n\x11TaskStatsResponse\x12&\n\x04type\x18\x01 \x01(\x0e\x32\x18.firmament.TaskReplyType\"?\n\x15ResourceStatsResponse\x12&\n\x04type\x18\x01 \x01(\x0e\x32\x18.firmament.NodeReplyType\"*\n\x12HealthCheckRequest\x12\x14\n\x0cgrpc_service\x18\x01 \x01(\t\"?\n\x13HealthCheckResponse\x12(\n\x06status\x18\x01 \x01(\x0e\x32\x18.firmament.ServingStatus*\xdf\x01\n\rTaskReplyType\x12\x15\n\x11TASK_COMPLETED_OK\x10\x00\x12\x15\n\x11TASK_SUBMITTED_OK\x10\x01\x12\x13\n\x0fTASK_REMOVED_OK\x10\x02\x12\x12\n\x0eTASK_FAILED_OK\x10\x03\x12\x13\n\x0fTASK_UPDATED_OK\x10\x04\x12\x12\n\x0eTASK_NOT_FOUND\x10\x05\x12\x16\n\x12TASK_JOB_NOT_FOUND\x10\x06\x12\x1a\n\x16TASK_ALREADY_SUBMITTED\x10\x07\x12\x1a\n\x16TASK_STATE_NOT_CREATED\x10\x08*\x8d\x01\n\rNodeReplyType\x12\x11\n\rNODE_ADDED_OK\x10\x00\x12\x12\n\x0eNODE_FAILED_OK\x10\x01\x12\x13\n\x0fNODE_REMOVED_OK\x10\x02\x12\x13\n\x0fNODE_UPDATED_OK\x10\x03\x12\x12\n\x0eNODE_NOT_FOUND\x10\x04\x12\x17\n\x13NODE_ALREADY_EXISTS\x10\x05*:\n\rServingStatus\x12\x0b\n\x07UNKNOWN\x10\x00\x12\x0b\n\x07SERVING\x10\x01\x12\x0f\n\x0bNOT_SERVING\x10\x02\x32\xea\x07\n\x12\x46irmamentScheduler\x12\x45\n\x08Schedule\x12\x1a.firmament.ScheduleRequest\x1a\x1b.firmament.SchedulingDeltas\"\x00\x12G\n\rTaskCompleted\x12\x12.firmament.TaskUID\x1a .firmament.TaskCompletedResponse\"\x00\x12\x41\n\nTaskFailed\x12\x12.firmament.TaskUID\x1a\x1d.firmament.TaskFailedResponse\"\x00\x12\x43\n\x0bTaskRemoved\x12\x12.firmament.TaskUID\x1a\x1e.firmament.TaskRemovedResponse\"\x00\x12O\n\rTaskSubmitted\x12\x1a.firmament.TaskDescription\x1a .firmament.TaskSubmittedResponse\"\x00\x12K\n\x0bTaskUpdated\x12\x1a.firmament.TaskDescription\x1a\x1e.firmament.TaskUpdatedResponse\"\x00\x12V\n\tNodeAdded\x12).firmament.ResourceTopologyNodeDescriptor\x1a\x1c.firmament.NodeAddedResponse\"\x00\x12\x45\n\nNodeFailed\x12\x16.firmament.ResourceUID\x1a\x1d.firmament.NodeFailedResponse\"\x00\x12G\n\x0bNodeRemoved\x12\x16.firmament.ResourceUID\x1a\x1e.firmament.NodeRemovedResponse\"\x00\x12Z\n\x0bNodeUpdated\x12).firmament.ResourceTopologyNodeDescriptor\x1a\x1e.firmament.NodeUpdatedResponse\"\x00\x12\x44\n\x0c\x41\x64\x64TaskStats\x12\x14.firmament.TaskStats\x1a\x1c.firmament.TaskStatsResponse\"\x00\x12L\n\x0c\x41\x64\x64NodeStats\x12\x18.firmament.ResourceStats\x1a .firmament.ResourceStatsResponse\"\x00\x12\x46\n\x05\x43heck\x12\x1d.firmament.HealthCheckRequest\x1a\x1e.firmament.HealthCheckResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'firmament_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TASKREPLYTYPE._serialized_start=6412
  _TASKREPLYTYPE._serialized_end=6635
  _NODEREPLYTYPE._serialized_start=6638
  _NODEREPLYTYPE._serialized_end=6779
  _SERVINGSTATUS._serialized_start=6781
  _SERVINGSTATUS._serialized_end=6839
  _RESOURCEVECTOR._serialized_start=31
  _RESOURCEVECTOR._serialized_end=172
  _LABEL._serialized_start=174
  _LABEL._serialized_end=209
  _LABELSELECTOR._serialized_start=212
  _LABELSELECTOR._serialized_end=389
  _LABELSELECTOR_SELECTORTYPE._serialized_start=311
  _LABELSELECTOR_SELECTORTYPE._serialized_end=389
  _REFERENCEDESCRIPTOR._serialized_start=392
  _REFERENCEDESCRIPTOR._serialized_end=828
  _REFERENCEDESCRIPTOR_REFERENCETYPE._serialized_start=695
  _REFERENCEDESCRIPTOR_REFERENCETYPE._serialized_end=785
  _REFERENCEDESCRIPTOR_REFERENCESCOPE._serialized_start=787
  _REFERENCEDESCRIPTOR_REFERENCESCOPE._serialized_end=828
  _TASKFINALREPORT._serialized_start=831
  _TASKFINALREPORT._serialized_end=999
  _WHAREMAPSTATS._serialized_start=1001
  _WHAREMAPSTATS._serialized_end=1115
  _COCOINTERFERENCESCORES._serialized_start=1117
  _COCOINTERFERENCESCORES._serialized_end=1235
  _TASKDESCRIPTOR._serialized_start=1238
  _TASKDESCRIPTOR._serialized_end=2526
  _TASKDESCRIPTOR_TASKSTATE._serialized_start=2321
  _TASKDESCRIPTOR_TASKSTATE._serialized_end=2468
  _TASKDESCRIPTOR_TASKTYPE._serialized_start=2470
  _TASKDESCRIPTOR_TASKTYPE._serialized_end=2526
  _JOBDESCRIPTOR._serialized_start=2529
  _JOBDESCRIPTOR._serialized_end=2788
  _JOBDESCRIPTOR_JOBSTATE._serialized_start=2690
  _JOBDESCRIPTOR_JOBSTATE._serialized_end=2788
  _RESOURCEDESCRIPTOR._serialized_start=2791
  _RESOURCEDESCRIPTOR._serialized_end=4099
  _RESOURCEDESCRIPTOR_RESOURCESTATE._serialized_start=3762
  _RESOURCEDESCRIPTOR_RESOURCESTATE._serialized_end=3856
  _RESOURCEDESCRIPTOR_RESOURCETYPE._serialized_start=3859
  _RESOURCEDESCRIPTOR_RESOURCETYPE._serialized_end=4099
  _RESOURCETOPOLOGYNODEDESCRIPTOR._serialized_start=4102
  _RESOURCETOPOLOGYNODEDESCRIPTOR._serialized_end=4268
  _SCHEDULINGDELTA._serialized_start=4271
  _SCHEDULINGDELTA._serialized_end=4440
  _SCHEDULINGDELTA_CHANGETYPE._serialized_start=4381
  _SCHEDULINGDELTA_CHANGETYPE._serialized_end=4440
  _TASKSTATS._serialized_start=4443
  _TASKSTATS._serialized_end=4977
  _CPUSTATS._serialized_start=4979
  _CPUSTATS._serialized_end=5086
  _RESOURCESTATS._serialized_start=5089
  _RESOURCESTATS._serialized_end=5337
  _SCHEDULEREQUEST._serialized_start=5339
  _SCHEDULEREQUEST._serialized_end=5356
  _SCHEDULINGDELTAS._serialized_start=5358
  _SCHEDULINGDELTAS._serialized_end=5420
  _TASKDESCRIPTION._serialized_start=5422
  _TASKDESCRIPTION._serialized_end=5541
  _TASKUID._serialized_start=5543
  _TASKUID._serialized_end=5570
  _RESOURCEUID._serialized_start=5572
  _RESOURCEUID._serialized_end=5607
  _TASKCOMPLETEDRESPONSE._serialized_start=5609
  _TASKCOMPLETEDRESPONSE._serialized_end=5672
  _TASKSUBMITTEDRESPONSE._serialized_start=5674
  _TASKSUBMITTEDRESPONSE._serialized_end=5737
  _TASKREMOVEDRESPONSE._serialized_start=5739
  _TASKREMOVEDRESPONSE._serialized_end=5800
  _TASKFAILEDRESPONSE._serialized_start=5802
  _TASKFAILEDRESPONSE._serialized_end=5862
  _TASKUPDATEDRESPONSE._serialized_start=5864
  _TASKUPDATEDRESPONSE._serialized_end=5925
  _NODEADDEDRESPONSE._serialized_start=5927
  _NODEADDEDRESPONSE._serialized_end=5986
  _NODEREMOVEDRESPONSE._serialized_start=5988
  _NODEREMOVEDRESPONSE._serialized_end=6049
  _NODEFAILEDRESPONSE._serialized_start=6051
  _NODEFAILEDRESPONSE._serialized_end=6111
  _NODEUPDATEDRESPONSE._serialized_start=6113
  _NODEUPDATEDRESPONSE._serialized_end=6174
  _TASKSTATSRESPONSE._serialized_start=6176
  _TASKSTATSRESPONSE._serialized_end=6235
  _RESOURCESTATSRESPONSE._serialized_start=6237
  _RESOURCESTATSRESPONSE._serialized_end=6300
  _HEALTHCHECKREQUEST._serialized_start=6302
  _HEALTHCHECKREQUEST._serialized_end=6344
  _HEALTHCHECKRESPONSE._serialized_start=6346
  _HEALTHCHECKRESPONSE._serialized_end=6409
  _FIRMAMENTSCHEDULER._serialized_start=6842
  _FIRMAMENTSCHEDULER._serialized_end=7844
# @@protoc_insertion_point(module_scope)
