"""The sharded checkpoint store (npz shards and a manifest)."""
