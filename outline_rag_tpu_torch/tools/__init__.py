"""Developer tools of the port; nothing on the serving path imports them."""
