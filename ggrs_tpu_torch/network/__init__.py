"""The network stack of the port: wire codec, transports, per-peer protocol."""
