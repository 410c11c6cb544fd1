"""Camera-movement template banks (original text).

Bank structure parity with camera_movement/TEMPLATES.py: 9 question types,
30 question templates each, 10 task descriptions, 10 answer templates each.
Placeholders are identical: {x_movement}, {y_movement}, {z_movement},
{yaw_movement}, {pitch_movement}, {x_distance}, {y_distance}, {z_distance},
{yaw_angle}, {pitch_angle}, {x_value}, {y_value}, {z_value},
{total_distance}. Camera convention text (X right, Y down, Z forward) is
preserved where the reference includes it (TEMPLATES.py:19-20, 287-316).
"""

from . import expand

_OPEN = [
    "Between the two photos,",
    "Comparing the first and second image,",
    "Judging from these two views,",
    "Based on the change between the frames,",
    "From the first capture to the second,",
    "Looking across the two shots,",
]

QUESTION_TEMPLATES = {
    "x_movement": expand(
        _OPEN,
        [
            "did the camera translate to the left or to the right?",
            "was the camera's sideways motion leftward or rightward?",
            "has the camera ended up farther left or farther right?",
            "do you judge the horizontal camera shift to be left or right?",
            "which side did the camera slide toward, left or right?",
        ],
        limit=28,
    ) + [
        "The first image defines positive X as right, Y as down and Z as "
        "forward. Along that X axis, did the camera go left or right?",
        "Taking X to the right, Y downward and Z forward in the first "
        "frame, was the camera's X motion to the left or the right?",
    ],
    "y_movement": expand(
        _OPEN,
        [
            "did the camera rise or sink?",
            "was the vertical camera change upward or downward?",
            "is the camera now higher or lower than before?",
            "would you call the height change of the camera up or down?",
            "did the shooting position move up or move down?",
        ],
        limit=30,
    ),
    "z_movement": expand(
        _OPEN,
        [
            "did the camera push into the scene or pull away from it?",
            "was the depth motion of the camera forward or backward?",
            "did the camera close in on the subject or back off?",
            "is the camera nearer to the scene (forward) or farther (backward)?",
            "would you describe the camera's depth change as forward or backward?",
        ],
        limit=30,
    ),
    "yaw_movement": [
        "Yaw is the rotation of the camera's forward axis about the gravity "
        "axis, i.e. its left-right turn. " + q
        for q in expand(
            _OPEN,
            ["did the camera turn to the left or to the right?",
             "was the camera's horizontal rotation leftward or rightward?",
             "which way did the camera swivel, left or right?"],
            limit=9,
        )
    ] + expand(
        _OPEN,
        [
            "did the camera rotate left or rotate right?",
            "did the view swing toward the left or toward the right?",
            "was the heading change of the camera to the left or the right?",
            "which direction did the camera pan, left or right?",
        ],
        limit=21,
    ),
    "pitch_movement": [
        "Pitch is the angle between the camera's forward axis and the "
        "ground, i.e. its up-down tilt. " + q
        for q in expand(
            _OPEN,
            ["did the camera tilt upward or downward?",
             "was the camera's vertical rotation up or down?",
             "which way did the camera nod, up or down?"],
            limit=9,
        )
    ] + expand(
        _OPEN,
        [
            "did the camera rotate up or rotate down?",
            "did the view tip toward the ceiling or toward the floor?",
            "was the tilt change of the camera upward or downward?",
            "which direction did the camera pitch, up or down?",
        ],
        limit=21,
    ),
    "total_distance": expand(
        _OPEN,
        [
            "how many millimeters did the camera travel in total?",
            "what is the straight-line distance (mm) between the two camera positions?",
            "how large is the camera's overall displacement in mm?",
            "what total movement distance, in millimeters, separates the two viewpoints?",
            "can you state the length of the camera's translation in mm?",
        ],
        limit=30,
    ),
    "yaw_angle": [
        "Yaw is the rotation of the camera's forward axis about the gravity "
        "axis, i.e. its left-right turn. " + q
        for q in expand(
            _OPEN,
            ["by how many degrees did the camera rotate horizontally?",
             "what is the magnitude of the yaw change in degrees?",
             "how big is the left-right rotation, in degrees?"],
            limit=9,
        )
    ] + expand(
        _OPEN,
        [
            "how many degrees did the camera turn about the vertical axis?",
            "what is the horizontal rotation angle in degrees?",
            "by what angle, in degrees, did the camera pan?",
            "how many degrees of side-to-side rotation occurred?",
        ],
        limit=21,
    ),
    "pitch_angle": [
        "Pitch is the angle between the camera's forward axis and the "
        "ground, i.e. its up-down tilt. " + q
        for q in expand(
            _OPEN,
            ["by how many degrees did the camera rotate vertically?",
             "what is the magnitude of the pitch change in degrees?",
             "how big is the up-down rotation, in degrees?"],
            limit=9,
        )
    ] + expand(
        _OPEN,
        [
            "how many degrees did the camera tilt about the horizontal axis?",
            "what is the vertical rotation angle in degrees?",
            "by what angle, in degrees, did the camera nod?",
            "how many degrees of up-down rotation occurred?",
        ],
        limit=21,
    ),
    "displacement_vector": [
        prefix + " " + core
        for prefix, core in zip(
            [
                "The first image sets positive X to the right, Y downward "
                "and Z forward.",
                "Use the first frame's axes: X right, Y down, Z forward.",
                "With X pointing right, Y down and Z forward in image one,",
                "Axes follow the first image: +X right, +Y down, +Z forward.",
                "Adopting X=right, Y=down, Z=forward from the first view,",
                "In the first image's frame (X right, Y down, Z forward),",
            ] * 5,
            expand(
                [
                    "what is the camera's full displacement vector "
                    "`[ x , y , z ]` in millimeters?",
                    "report the camera translation as `[ x , y , z ]` in mm.",
                    "give the three-axis movement of the camera in mm as "
                    "`[ x , y , z ]`.",
                    "how did the camera move along each axis, as a "
                    "`[ x , y , z ]` triple in mm?",
                    "state the net camera translation vector in mm.",
                ],
                [
                    "",
                    "Treat the motion as relative to the first viewpoint.",
                    "Express every component in millimeters.",
                    "Components may be negative.",
                    "Measure from the first position to the second.",
                    "Round each component to an integer.",
                ],
                limit=30,
            ),
        )
    ],
}

TASK_DESCRIPTION = [
    "Image-1: <image>\nImage-2: <image>\n" + body
    + " Describe the motion relative to the first image, and assume every "
      "object in the scene stayed still."
    for body in [
        "Work out how the camera moved between these two captures.",
        "Study both pictures and characterize the camera's change of pose.",
        "Figure out the camera motion that explains the difference between the views.",
        "These two frames come from the same static scene; recover the camera movement.",
        "Infer the translation and rotation of the camera across the two images.",
        "Reason about the viewpoint change between the photographs.",
        "Estimate how the capturing camera was displaced and reoriented.",
        "Deduce the camera's movement by comparing the two frames.",
        "Identify the change in camera position and heading between the shots.",
        "Determine the relative camera pose of the second image.",
    ]
]

ANSWER_TEMPLATES = {
    "x_movement": expand(
        ["The camera moved", "Horizontally, the camera went",
         "The sideways motion was", "Its horizontal translation was",
         "The camera slid"],
        ["`{x_movement}`.", "`{x_movement}` along the horizontal axis."],
        limit=10,
    ),
    "y_movement": expand(
        ["The camera moved", "Vertically, the camera went",
         "The height change was", "Its vertical translation was",
         "The camera shifted"],
        ["`{y_movement}`.", "`{y_movement}` in the vertical direction."],
        limit=10,
    ),
    "z_movement": expand(
        ["The camera moved", "In depth, the camera went",
         "The depth change was", "Its motion along the view axis was",
         "The camera traveled"],
        ["`{z_movement}`.", "`{z_movement}` along the depth axis."],
        limit=10,
    ),
    "yaw_movement": expand(
        ["The camera rotated", "Its yaw changed", "The camera panned",
         "Horizontally it turned", "The heading swung"],
        ["`{yaw_movement}`.", "`{yaw_movement}` about the vertical axis."],
        limit=10,
    ),
    "pitch_movement": expand(
        ["The camera tilted", "Its pitch changed", "The camera nodded",
         "Vertically it turned", "The view tipped"],
        ["`{pitch_movement}`.", "`{pitch_movement}` about the horizontal axis."],
        limit=10,
    ),
    "total_distance": expand(
        ["The camera traveled", "The total displacement is",
         "The cameras are separated by", "The movement spans",
         "The net travel comes to"],
        ["`{total_distance}` mm.", "about `{total_distance}` mm."],
        limit=10,
    ),
    "yaw_angle": expand(
        ["The yaw change is", "It rotated", "The horizontal turn measures",
         "The pan amounts to", "The left-right rotation is"],
        ["`{yaw_angle}` degrees.", "`{yaw_angle}` degrees about the vertical."],
        limit=10,
    ),
    "pitch_angle": expand(
        ["The pitch change is", "It tilted", "The vertical turn measures",
         "The nod amounts to", "The up-down rotation is"],
        ["`{pitch_angle}` degrees.", "`{pitch_angle}` degrees about the horizontal."],
        limit=10,
    ),
    "displacement_vector": expand(
        ["The displacement vector is", "The camera translation equals",
         "Its movement in 3D is", "The net shift is",
         "The per-axis motion is"],
        ["`[ {x_value} , {y_value} , {z_value} ]` mm.",
         "`[ {x_value} , {y_value} , {z_value} ]` in millimeters."],
        limit=10,
    ),
}

# Sanity constants mirrored from the reference bank sizes.
N_QUESTION_TEMPLATES = 30
N_TASK_DESCRIPTIONS = 10
N_ANSWER_TEMPLATES = 10
