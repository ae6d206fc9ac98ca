"""The traffic mixes' runners, one file each (``<runner>.py`` defining
``Runner``), found by the name a mix gives; ``base`` holds what they
share."""
