"""The node agent: wiring of all plugins + CNI server + node networking.

Reference analog: the contiv-agent process — flavors/contiv DI wiring,
plugins/contiv (remoteCNIserver, node events, node-ID allocation).
"""
