"""Depth-perception template banks (original text).

Parity targets: depth_estimation_coor_engine.py:55-154,
depth_estimation_dot_engine.py:55-130, depth_comparison_coor_engine.py
:57-219, depth_comparison_dot_engine.py:60-300. Placeholder names match the
reference exactly: {x1} {y1} {x2} {y2} {depth} {correct_x} {correct_y}
{correct_label}.
"""

from . import expand

# The 0-1000 coordinate-convention sentence (semantic content parity with
# the reference prose, e.g. depth_estimation_coor_engine.py:56).
COORD_NOTE = (
    "Point coordinates [ x , y ] are expressed on a 0-1000 scale: they are "
    "normalized by the image size and multiplied by 1000, with [ 0 , 0 ] at "
    "the top-left corner; x runs along the width and y along the height."
)

EST_COOR_TASK_DESCRIPTION = [
    f"<image>\n{body} {COORD_NOTE}"
    for body in expand(
        ["Given one image and the 2D coordinates of a point,",
         "Using the picture and a point specified by its coordinates,",
         "For the image below and the indicated 2D point,",
         "With the provided image and a queried point,",
         "Taking the single image and a coordinate-specified point,",
         "Looking at the image and the given point,"],
        ["answer the depth question.",
         "complete the question-answer task.",
         "work out the requested depth value.",
         "resolve the depth query.",
         "provide the answer about its distance."],
        limit=30,
    )
]

EST_DOT_TASK_DESCRIPTION = [
    f"<image>\n{body}"
    for body in expand(
        ["One point in this image is marked with a colored dot.",
         "The image contains a single annotated point.",
         "A dot highlights one specific point in the picture.",
         "This image carries one marked location.",
         "A single point has been drawn onto the image.",
         "The picture shows one highlighted point."],
        ["Answer the depth question about it.",
         "Complete the question-answer task for that point.",
         "Work out the requested depth value for it.",
         "Resolve the depth query for the marked point.",
         "Provide the answer about its distance from the camera."],
        limit=30,
    )
]

EST_QUESTIONS_COOR = expand(
    ["What is the depth at [ {x1} , {y1} ]",
     "How far from the camera is the point [ {x1} , {y1} ]",
     "What distance separates the viewer from [ {x1} , {y1} ]",
     "How deep does the point [ {x1} , {y1} ] lie",
     "What depth value belongs to the location [ {x1} , {y1} ]",
     "What is the camera distance of the point at [ {x1} , {y1} ]"],
    ["in this image (mm)?", "in millimeters?", "(answer in mm)?",
     "as measured in mm?", "expressed in millimeters?"],
    limit=30,
)

EST_ANSWERS_COOR = expand(
    ["The depth at [ {x1} , {y1} ] is",
     "Point [ {x1} , {y1} ] lies at a depth of",
     "That location is at",
     "The camera distance there is",
     "It measures", "The point sits"],
    ["`{depth}` mm.", "`{depth}` millimeters from the camera.",
     "a depth of `{depth}` mm.", "`{depth}` mm away.",
     "`{depth}` mm deep."],
    limit=30,
)

EST_QUESTIONS_DOT = expand(
    ["What is the depth of the annotated point",
     "How far from the camera is the marked point",
     "What distance separates the viewer from the highlighted point",
     "How deep does the dotted point lie",
     "What depth value belongs to the marked location",
     "What is the camera distance of the annotated point"],
    ["in this image (mm)?", "in millimeters?", "(answer in mm)?",
     "as measured in mm?", "expressed in millimeters?"],
    limit=30,
)

EST_ANSWERS_DOT = expand(
    ["The annotated point is at", "The marked point lies at",
     "That point sits at", "The highlighted location is at",
     "Its depth is", "The dot marks a depth of"],
    ["`{depth}` mm.", "a distance of `{depth}` mm from the camera.",
     "`{depth}` millimeters.", "`{depth}` mm from the viewer.",
     "depth `{depth}` mm."],
    limit=30,
)

COMP_COOR_TASK_DESCRIPTION = [
    f"<image>\n{body} {COORD_NOTE}"
    for body in expand(
        ["Two points in this image are given by their coordinates.",
         "You are given the coordinates of two points in the picture.",
         "Consider the two coordinate-specified points in this image.",
         "The image comes with two queried points."],
        ["Decide which one is closer to or farther from the camera.",
         "Determine which lies nearer to or more distant from the viewer.",
         "Judge their relative distance to the camera.",
         "Compare their depths.",
         "Say which has the smaller or the larger camera distance."],
        limit=20,
    )
]

COMP_DOT_TASK_DESCRIPTION = [
    f"<image>\n{body}"
    for body in expand(
        ["Two points in this image are marked with lettered dots.",
         "The picture contains two annotated, lettered points.",
         "Two labeled dots highlight points in this image.",
         "This image carries two letter-tagged marks."],
        ["Decide which one is closer to or farther from the camera.",
         "Determine which lies nearer to or more distant from the viewer.",
         "Judge their relative distance to the camera.",
         "Compare their depths.",
         "Say which has the smaller or the larger camera distance."],
        limit=20,
    )
]

COMP_CLOSER_QUESTIONS_COOR = expand(
    ["Which point is closer to the camera:",
     "Which of the two lies nearer to the viewer:",
     "Which location has the smaller depth:",
     "Which one sits at the shorter camera distance:",
     "Which of these points is the nearer one:",
     "Which point would you say is closest to the camera:"],
    ["[ {x1} , {y1} ] or [ {x2} , {y2} ]?",
     "the point [ {x1} , {y1} ] or the point [ {x2} , {y2} ]?",
     "[ {x1} , {y1} ] versus [ {x2} , {y2} ]?",
     "the first point [ {x1} , {y1} ] or the second [ {x2} , {y2} ]?",
     "point [ {x1} , {y1} ] or point [ {x2} , {y2} ]?"],
    limit=30,
)

COMP_FARTHER_QUESTIONS_COOR = expand(
    ["Which point is farther from the camera:",
     "Which of the two lies more distant from the viewer:",
     "Which location has the greater depth:",
     "Which one sits at the longer camera distance:",
     "Which of these points is the more remote one:",
     "Which point would you say is farthest from the camera:"],
    ["[ {x1} , {y1} ] or [ {x2} , {y2} ]?",
     "the point [ {x1} , {y1} ] or the point [ {x2} , {y2} ]?",
     "[ {x1} , {y1} ] versus [ {x2} , {y2} ]?",
     "the first point [ {x1} , {y1} ] or the second [ {x2} , {y2} ]?",
     "point [ {x1} , {y1} ] or point [ {x2} , {y2} ]?"],
    limit=30,
)

COMP_CLOSER_ANSWERS_COOR = expand(
    ["The closer point is", "The nearer of the two is",
     "The smaller camera distance belongs to",
     "Nearest to the viewer is", "The point with less depth is",
     "Closest to the camera is"],
    ["`[ {correct_x} , {correct_y} ]`.",
     "the point at `[ {correct_x} , {correct_y} ]`.",
     "the one at `[ {correct_x} , {correct_y} ]`.",
     "`[ {correct_x} , {correct_y} ]`, the indicated point.",
     "location `[ {correct_x} , {correct_y} ]`."],
    limit=30,
)

COMP_FARTHER_ANSWERS_COOR = expand(
    ["The farther point is", "The more distant of the two is",
     "The greater camera distance belongs to",
     "Most remote from the viewer is", "The point with more depth is",
     "Farthest from the camera is"],
    ["`[ {correct_x} , {correct_y} ]`.",
     "the point at `[ {correct_x} , {correct_y} ]`.",
     "the one at `[ {correct_x} , {correct_y} ]`.",
     "`[ {correct_x} , {correct_y} ]`, the indicated point.",
     "location `[ {correct_x} , {correct_y} ]`."],
    limit=30,
)

COMP_CLOSER_QUESTIONS_DOT = expand(
    ["Which of the lettered points is closer to the camera?",
     "Of the two marked points, which lies nearer to the viewer?",
     "Which annotated point has the smaller depth?",
     "Which labeled dot sits at the shorter camera distance?",
     "Between the two annotations, which is the nearer point?",
     "Which marked location is closest to the camera?"],
    ["", "Answer with its letter.", "Give the letter of that point.",
     "Reply with the corresponding letter.", "Name it by its label."],
    limit=30,
)

COMP_FARTHER_QUESTIONS_DOT = expand(
    ["Which of the lettered points is farther from the camera?",
     "Of the two marked points, which lies more distant from the viewer?",
     "Which annotated point has the greater depth?",
     "Which labeled dot sits at the longer camera distance?",
     "Between the two annotations, which is the more remote point?",
     "Which marked location is farthest from the camera?"],
    ["", "Answer with its letter.", "Give the letter of that point.",
     "Reply with the corresponding letter.", "Name it by its label."],
    limit=30,
)

COMP_CLOSER_ANSWERS_DOT = expand(
    ["The closer point is", "The nearer of the two is",
     "The smaller camera distance belongs to point",
     "Nearest to the viewer is point", "The point with less depth is",
     "Closest to the camera is point"],
    ["`{correct_label}`.", "`{correct_label}`, the marked point.",
     "the one labeled `{correct_label}`."],
    limit=30,
)

COMP_FARTHER_ANSWERS_DOT = expand(
    ["The farther point is", "The more distant of the two is",
     "The greater camera distance belongs to point",
     "Most remote from the viewer is point", "The point with more depth is",
     "Farthest from the camera is point"],
    ["`{correct_label}`.", "`{correct_label}`, the marked point.",
     "the one labeled `{correct_label}`."],
    limit=30,
)
