"""One driver per kind of traffic, named by the traffic file's ``kind``.

A driver is built from the run's context, warms the shapes its traffic
uses, drives the program through one measured window, and then checks what
the window produced against the reference.  Drivers are general: what one
cell sends (columns, rates, sizes, mixes) is data in its traffic file.
"""
