"""Native (C++) components, compiled on demand with g++ and loaded via ctypes.

The hot host-side pipeline step — suffix array construction — is native, as
in the reference (vendored libdivsufsort there, our own SA-IS here).
"""
