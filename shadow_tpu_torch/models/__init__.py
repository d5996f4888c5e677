"""Workload applications ("model families").

Plugin re-implementations of the workload behaviours the benchmark configs
need. Ported so far:

- echo:   minimal UDP request/response pair (smoke tests)
- tgen:   stream transfer client/server in tgen's shape (connect, request
          N bytes, stream back, record completion)
- gossip: Bitcoin-like inv/getdata/tx datagram flood
- tor:    onion-routing relays, exits and clients (3-hop circuits over
          streams)
- web:    HTTP/CDN tier: page-loop clients, edge caches, origins
- dns:    authoritative servers, a caching recursive resolver, and the
          stub client the web model resolves its edges with

A config naming another model of ``shadow_tpu.models`` is refused at load
(config/schema.py).
"""
