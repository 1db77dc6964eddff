"""The port's firmament gRPC service."""
