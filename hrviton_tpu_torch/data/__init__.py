"""The data path: VITON-HD reader (``dataset``, ``agnostic``), loader
(``loader``), synthetic fixture (``synthetic``), and the device-side
expansion of the compact wire format (``device``). Import the modules
themselves: the host-side ones need PIL, ``device`` (what runs on the card)
needs neither PIL nor msgpack.
"""
