"""The yardstick: loading cells by name, the clients, the plain
reference's plumbing, the trace reduction and the result line."""
